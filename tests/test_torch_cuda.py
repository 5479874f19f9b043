"""tpu2dgs_torch CUDA kernels vs their plain PyTorch versions, on the GPU.

Marked `cuda`: without a CUDA device the module skips at collection, so
a CPU run queues none of its items. The file imports nothing of JAX, so
it also runs where JAX is not installed; from the repo root on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from tpu2dgs_torch.eval import bin_probe, reduce_probe, synthetic
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import api, binning, cuda_backend, preprocess, select_kernel
from tpu2dgs_torch.raster.common import ALPHA_MIN, CUTOFF, FILTER_INV_SQUARE
from tpu2dgs_torch.train import loop
from torch_chunk_cases import CASES as CHUNK_CASES  # tests/ is on sys.path

if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device", allow_module_level=True)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    return torch.device("cuda")


def _box_case(dev, cap):
    """Box-only level: random AABBs, 3 parents, partial parent counts."""
    g = torch.Generator().manual_seed(0)
    NP, M, R = 3, 2500, 12  # M not a multiple of 1024: internal padding

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(dev)

    cx0, cy0 = u(0, 800, NP, M), u(0, 800, NP, M)
    ids = torch.arange(M, dtype=torch.float32).expand(NP, M).to(dev)
    rx0, ry0 = u(0, 700, R), u(0, 700, R)
    return dict(row_rects=(rx0, rx0 + 127, ry0, ry0 + 63),
                cand_channels=(cx0, cx0 + u(5, 300, NP, M), cy0, cy0 + u(5, 300, NP, M), ids),
                parent_of_row=torch.randint(0, NP, (R,), generator=g).to(dev), cap=cap,
                parent_counts=torch.randint(0, M, (R,), generator=g).to(dev))


def _exact_case(dev):
    """Exact-only level on real records with _REC_PADS past the count."""
    w, h = 256, 128
    cam, scene = synthetic.make_bench_scene(w, h, 400, device=dev)
    splats = preprocess.preprocess(*scene, cam, w, h, 3)
    comp = binning.compact_visible(splats, 400)
    rec = cuda_backend.pack_records(splats)[comp.perm.long()]
    pads = torch.tensor(cuda_backend._REC_PADS, device=dev)
    live = torch.arange(400, device=dev)[:, None] < comp.num_visible
    chans = torch.where(live, rec, pads).T[None].contiguous()
    tx0 = torch.tensor([0, 128, 0, 128, 64], dtype=torch.float32, device=dev)
    ty0 = torch.tensor([0, 0, 64, 64, 32], dtype=torch.float32, device=dev)
    return dict(row_rects=(tx0, tx0 + 127, ty0, ty0 + 63), cand_channels=chans,
                parent_of_row=torch.zeros(5, dtype=torch.int32, device=dev), cap=256,
                parent_counts=comp.num_visible.expand(5), box_idx=None,
                exact_idx=cuda_backend._EXACT_IDX, pad_vals=cuda_backend._REC_PADS)


def _l1_case(dev):
    """L1-shaped: 7 screen columns of an 800x800 image over one parent of
    131,072 box candidates, dense on the left, so the left columns
    overflow cap 32,768 and the right ones do not; the walk ends inside a
    macro block."""
    g = torch.Generator().manual_seed(1)
    m = 1 << 17
    x0 = 800 * torch.rand(1, m, generator=g) ** 2
    y0 = 800 * torch.rand(1, m, generator=g)
    x1 = x0 + 5 + 295 * torch.rand(1, m, generator=g)
    y1 = y0 + 5 + 295 * torch.rand(1, m, generator=g)
    ids = torch.arange(m, dtype=torch.float32)[None]
    cix = torch.arange(7, dtype=torch.float32)
    y_lo = torch.zeros(7)
    return dict(row_rects=tuple(a.to(dev) for a in (cix * 128, cix * 128 + 127, y_lo,
                                                    y_lo + 799)),
                cand_channels=tuple(a.to(dev) for a in (x0, x1, y0, y1, ids)),
                parent_of_row=torch.zeros(7, dtype=torch.int32, device=dev), cap=32768,
                parent_counts=torch.full((7,), 120_000, dtype=torch.int32, device=dev))


SELECT_CASES = {
    "box": lambda dev: _box_case(dev, 512),
    "box_overflow": lambda dev: _box_case(dev, 128),
    "exact_rec_pads": _exact_case,
    "l1_columns": _l1_case,
    # the CPU cases of the chunked compaction (tests/torch_chunk_cases.py)
    **{name: build for name, (build, _) in CHUNK_CASES.items()},
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_kernel_bit_equal(cuda, case):
    """Bit-equal to plain, values and TOTAL counts; two launches bit-equal."""
    kw = SELECT_CASES[case](cuda)
    before = native.LAUNCHES["select_values"]
    got, cnt = select_kernel.select_values(**kw)
    again, again_cnt = select_kernel.select_values(**kw)
    ref, ref_cnt = select_kernel.select_values_plain(**kw)
    torch.cuda.synchronize()
    assert native.LAUNCHES["select_values"] == before + 2
    assert torch.equal(cnt, ref_cnt) and torch.equal(again_cnt, cnt)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


# (SMs, CTAs per SM) posed to the wrapper: grids of 1, 3 and 7 CTAs, so
# counts and writes interleave in work_at's order and writes wait on counts
SMALL_GRIDS = [(1, 1), (1, 3), (7, 1)]


@pytest.mark.parametrize("grid", SMALL_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_kernel_small_grids(cuda, monkeypatch, case, grid):
    """The kernel's own work order over a few CTAs, where every CTA owns
    many count and write positions: bit-equal to plain, counts included.
    On one CTA every case (each has two rows or more) reaches the order's
    alternating part."""
    kw = SELECT_CASES[case](cuda)
    rows = kw["parent_of_row"].shape[0]
    m = -(-kw["cand_channels"][0].shape[-1] // select_kernel.MACRO) * select_kernel.MACRO
    plan = select_kernel.chunk_plan(rows, m, *grid)
    assert grid != (1, 1) or plan.positions // 2 > plan.ahead
    select_kernel.kernel_occupancy(cuda)  # builds the kernel on the real occupancy
    monkeypatch.setitem(select_kernel._OCCUPANCY, cuda.index or 0, grid)
    got, cnt = select_kernel.select_values(**kw)
    ref, ref_cnt = select_kernel.select_values_plain(**kw)
    assert torch.equal(cnt, ref_cnt)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_l1_case_overflows_some_columns(cuda):
    _, cnt = select_kernel.select_values(**_l1_case(cuda))
    assert bool((cnt > 32768).any()) and bool((cnt < 32768).any())


def test_select_values_makes_no_host_sync(cuda):
    """One call on bench-level-shaped arguments (M a multiple of 1024):
    one counted launch and no host synchronisation."""
    kw = _l1_case(cuda)
    select_kernel.select_values(**kw)  # builds the kernel, queries its occupancy
    torch.cuda.synchronize()
    before = native.LAUNCHES["select_values"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        select_kernel.select_values(**kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert native.LAUNCHES["select_values"] == before + 1
    torch.cuda.synchronize()


def test_select_values_raises_on_refused_launch(cuda, monkeypatch):
    """A cooperative grid larger than the card holds is refused: the
    wrapper raises, counts no launch, and the next launch runs."""
    kw = _l1_case(cuda)
    sms, per_sm = select_kernel.kernel_occupancy(cuda)
    assert 7 * 128 > sms * per_sm  # the case's items outnumber the resident CTAs
    monkeypatch.setitem(select_kernel._OCCUPANCY, cuda.index or 0, (sms, 8 * per_sm))
    before = native.LAUNCHES["select_values"]
    with pytest.raises(RuntimeError, match="select_values"):
        select_kernel.select_values(**kw)
    assert native.LAUNCHES["select_values"] == before
    monkeypatch.undo()
    got, cnt = select_kernel.select_values(**kw)
    ref, ref_cnt = select_kernel.select_values_plain(**kw)
    assert torch.equal(cnt, ref_cnt) and torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _tickets_zero() -> bool:
    return not any(bool(t.any()) for t in select_kernel._TICKETS.values())


def _count_args(kw):
    """select_counts' arguments of a select case, and its walk's M."""
    kw = {k: v for k, v in kw.items() if k != "cap"}
    m = -(-kw["cand_channels"][0].shape[-1] // select_kernel.MACRO) * select_kernel.MACRO
    return kw, m


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_count_kernel_bit_equal(cuda, case):
    """The count-only kernel against its plain version and against the
    counts the select kernel returns for the same arguments; two launches
    equal, one counted launch a call, every ticket back at zero."""
    kw = SELECT_CASES[case](cuda)
    _, k1_counts = select_kernel.select_values(**kw)
    kw, _ = _count_args(kw)
    before = native.LAUNCHES["select_counts"]
    got = select_kernel.select_counts(**kw)
    assert native.LAUNCHES["select_counts"] == before + 1
    again = select_kernel.select_counts(**kw)
    ref = select_kernel.select_counts_plain(**kw)
    torch.cuda.synchronize()
    assert native.LAUNCHES["select_counts"] == before + 2
    assert got.dtype == torch.int32
    assert torch.equal(got, ref) and torch.equal(got, k1_counts) and torch.equal(again, got)
    assert _tickets_zero()


@pytest.mark.parametrize("grid", SMALL_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_count_kernel_small_grids(cuda, monkeypatch, case, grid):
    """The count kernel over grids of 1, 3 and 7 CTAs, where a CTA takes
    many items and a row's last ticket may fall to any of them, with every
    buffer the wrapper allocates filled with junk first: counts equal plain
    whatever the memory held, every ticket back at zero."""
    kw, m = _count_args(SELECT_CASES[case](cuda))
    plan = select_kernel.count_plan(kw["parent_of_row"].shape[0], m, *grid)
    assert grid != (1, 1) or plan.items > plan.ctas
    ref = select_kernel.select_counts_plain(**kw)
    select_kernel.count_occupancy(cuda)  # builds the kernel on the real occupancy
    monkeypatch.setitem(select_kernel._COUNT_OCCUPANCY, cuda.index or 0, grid)
    empty = torch.empty
    for junk in (-1, 0x12345678):
        monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(junk))
        got = select_kernel.select_counts(**kw)
        monkeypatch.setattr(torch, "empty", empty)
        assert torch.equal(got, ref), junk
    torch.cuda.synchronize()
    assert _tickets_zero()


def test_count_kernel_raises_on_refused_launch(cuda, monkeypatch):
    """A grid of no CTAs is refused by the launcher: the wrapper raises,
    counts no launch, leaves the tickets at zero, and the next launch is
    right."""
    kw, _ = _count_args(_box_case(cuda, 512))
    select_kernel.count_occupancy(cuda)
    monkeypatch.setitem(select_kernel._COUNT_OCCUPANCY, cuda.index or 0, (0, 4))
    before = native.LAUNCHES["select_counts"]
    with pytest.raises(RuntimeError, match="select_counts"):
        select_kernel.select_counts(**kw)
    assert native.LAUNCHES["select_counts"] == before
    monkeypatch.undo()
    got = select_kernel.select_counts(**kw)
    assert torch.equal(got, select_kernel.select_counts_plain(**kw)) and _tickets_zero()


def _distinct_base(dev):
    """A (16,128) input of 2048 distinct values in [0, 1): a fragment read
    from or written to the wrong column shows in the row."""
    g = torch.Generator().manual_seed(5)
    return ((torch.randperm(2048, generator=g).float() + 0.5) / 2048).reshape(16, 128).to(dev)


@pytest.mark.parametrize("name", ["reduce_probe_shuffle", "reduce_probe_mma"])
@pytest.mark.parametrize("steps", [1, 7, 512])
@pytest.mark.parametrize("inputs", ["seed1", "distinct"])
def test_reduce_probe_kernels_match_plain(cuda, name, steps, inputs):
    """Every element of the row within relative 1e-5 of the plain version
    (the same float32 terms summed in another order), and two launches
    bit-equal."""
    base = reduce_probe.probe_input(1, cuda) if inputs == "seed1" else _distinct_base(cuda)
    before = native.LAUNCHES[name]
    got = getattr(reduce_probe, name)(base, steps)
    again = getattr(reduce_probe, name)(base, steps)
    ref = reduce_probe.reduce_probe_plain(base, steps)
    torch.cuda.synchronize()
    assert native.LAUNCHES[name] == before + 2
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_bin_probe_small(cuda, capsys):
    """The binning probe end to end on a small scene: it checks the
    count-only levels against L2's and L3's counts itself."""
    res = bin_probe.run(cuda, w=256, h=96, n=3000, bin_cap=1024, tile_cap=384, reps=2)
    assert res["launches"] == {"select_values": 3 * res["passes"],
                               "select_counts": 2 * res["passes"]}
    assert set(res["ms"]) == {"L1 columns", "col gather+transpose", "L2 coarse bins (exact)",
                              "L3 fine tiles (exact)", "L2 count-only", "L3 count-only"}
    assert res["tile_counts"] > 0 and "L3 count-only" in capsys.readouterr().out


def _scene(dev, w=256, h=96, n=3000):
    cam, scene = synthetic.make_bench_scene(w, h, n, device=dev)
    return cam, scene, api.RasterSettings(w, h, bin_capacity=1024, tile_capacity=384)


def _lists(dev, tile_row0=0, nty=None):
    """Per-tile record lists of the small scene, or of its strip of `nty`
    tile rows from `tile_row0`: (rec3, counts, nty)."""
    cam, scene, settings = _scene(dev)
    splats = preprocess.preprocess(*scene, cam, settings.width, settings.height, 3)
    comp = binning.compact_visible(splats, scene[0].shape[0])
    rec = cuda_backend.pack_records(splats)
    nbx, nty = -(-settings.width // 128), nty or -(-settings.height // 16)
    rec3, raw, _, _ = cuda_backend._bin_records(
        comp.x0, comp.x1, comp.y0, comp.y1, comp.num_visible, rec, nbx, nty, 1024, 384,
        tile_row0, ids=comp.perm)
    return rec3, torch.clamp(raw, max=rec3.shape[2]).to(torch.int32), nty


def _disk_lists(dev, tiles_x=2, nty=6, count=448, capk=512):
    """Hand-made lists of screen-aligned disks in depth order: entry j of a
    tile is a disk of radius 4-8 px (its 3-sigma cutoff 12-24 px) centred in
    sub-tile r with a weight (r + 1)^2, so sub-tile 7 saturates within the
    first chunks and sub-tile 0 never does. te2 and fr2 as preprocess
    states them. (rec3 (T, 24, capk), counts, nty)."""
    g = torch.Generator().manual_seed(0)
    t = tiles_x * nty
    tiles = torch.arange(t)
    sub = torch.multinomial(torch.arange(1, 9, dtype=torch.float32) ** 2, t * count,
                            replacement=True, generator=g).reshape(t, count)
    cx = ((tiles // nty) * 128)[:, None] + 16 * sub + 16 * torch.rand(t, count, generator=g)
    cy = ((tiles % nty) * 16)[:, None] + 16 * torch.rand(t, count, generator=g)
    s = 4.0 + 4.0 * torch.rand(t, count, generator=g)
    op = 0.5 + 0.49 * torch.rand(t, count, generator=g)
    tau_a2 = 2.0 * torch.log(op / ALPHA_MIN)
    rec = torch.zeros(t, 24, count)
    rec[:, 0], rec[:, 6] = 1.0 / s, -cx / s          # pu = (x - cx) / s
    rec[:, 4], rec[:, 7] = 1.0 / s, -cy / s          # pv = (y - cy) / s
    rec[:, 8] = 1.0                                  # pw = 1
    rec[:, 11] = 1.0 + 0.01 * torch.arange(count)    # depth, increasing
    rec[:, 12:15] = torch.rand(t, 3, count, generator=g)
    rec[:, 17] = -1.0
    rec[:, 18], rec[:, 19], rec[:, 20] = op, cx, cy
    rec[:, 21] = torch.arange(t * count, dtype=torch.float32).reshape(t, count)
    rec[:, 22] = torch.clamp(tau_a2, 1e-6, CUTOFF * CUTOFF) * 1.001 + 1e-5
    rec[:, 23] = torch.clamp(tau_a2, min=1e-6) / FILTER_INV_SQUARE * 1.001 + 1e-5
    pads = torch.tensor(cuda_backend._REC_PADS)[None, :, None].expand(t, 24, capk - count)
    rec3 = torch.cat([rec, pads], dim=2).contiguous().to(dev)
    return rec3, torch.full((t,), count, dtype=torch.int32, device=dev), nty


def _crafted(dev, case):
    """Lists with edge cases for the sub-tile cull.

    `empty_subtiles`: the small scene's lists, each tile keeping only the
    entries that reach none of its sub-tiles 4-7, so those walk empty
    masks. `saturating`: `_disk_lists`, whose sub-tiles saturate at
    different chunks or never."""
    if case == "saturating":
        return _disk_lists(dev)
    rec3, counts, nty = _lists(dev)
    t, nch, capk = rec3.shape
    cov = cuda_backend.subtile_coverage(rec3, counts, nty)
    keep = cov.any(dim=1) & ~cov[:, 4:].any(dim=1)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    rec3 = torch.gather(rec3, 2, order[:, None, :].expand(t, nch, capk))
    counts = keep.sum(dim=1).to(torch.int32)
    past = torch.arange(capk, device=dev)[None, :] >= counts[:, None]
    pads = torch.tensor(cuda_backend._REC_PADS, device=dev)[None, :, None]
    return torch.where(past[:, None, :], pads, rec3).contiguous(), counts, nty


def _blend_matches_plain(rec3, counts, nty, row0=0):
    before = native.LAUNCHES["blend_tiles"]
    got = cuda_backend.blend_tiles(rec3, counts, nty, row0)
    ref = cuda_backend.blend_tiles_plain(rec3, counts, nty, row0)
    torch.cuda.synchronize()
    assert native.LAUNCHES["blend_tiles"] == before + 1
    assert float((got[:, :12] - ref[:, :12]).abs().max()) <= 1e-5
    assert float((got[:, 12] != ref[:, 12]).float().mean()) <= 1e-4
    return ref


@pytest.mark.parametrize("room", ["room", "overflow"])
def test_blend_kernels_at_a_row_offset(cuda, room):
    """K2 and K3 on the strip of tile rows 4 .. 7 of the small scene (rows 6
    and 7 below the image), placed at row0 = 4: against their plain
    versions, and unlike the same lists placed at row 0."""
    rec3, counts, nty = _lists(cuda, tile_row0=4, nty=4)
    assert int(counts.sum()) > 0
    ref = _blend_matches_plain(rec3, counts, nty, row0=4)
    assert not torch.equal(ref, cuda_backend.blend_tiles(rec3, counts, nty, 0))
    _backward_matches_plain(rec3, counts, nty, room, row0=4)
    with pytest.raises(ValueError):
        cuda_backend.blend_tiles(rec3, counts, nty, -4)


def test_blend_kernel_matches_plain(cuda):
    """Lists that span several staging chunks and reach the capacity."""
    rec3, counts, nty = _lists(cuda)
    assert int(counts.max()) == rec3.shape[2] > 4 * cuda_backend.CHUNK
    _blend_matches_plain(rec3, counts, nty)


@pytest.mark.parametrize("case", ["empty_subtiles", "saturating"])
def test_blend_kernel_subtile_cases(cuda, case):
    rec3, counts, nty = _crafted(cuda, case)
    ref = _blend_matches_plain(rec3, counts, nty)
    # last contributor's chunk per (tile, sub-tile)
    last = ref[:, 12].reshape(-1, cuda_backend.BY, 8, cuda_backend.SUB).amax(dim=(1, 3))
    if case == "empty_subtiles":
        live = counts > 0
        assert bool(live.any()) and bool((last[live][:, 4:] == -1).all())
        assert bool((last[live][:, :4] >= 0).any())
    else:
        # per tile: some sub-tiles saturated (every pixel's T below 1e-2, where
        # a kill leaves it), others not
        sat = ref[:, 3].reshape(-1, cuda_backend.BY, 8, cuda_backend.SUB).amax(dim=(1, 3)) < 1e-2
        assert bool((sat.any(dim=1) & ~sat.all(dim=1)).all())


def test_blend_wrappers_need_24_channels(cuda):
    """The sub-tile cull reads te2 and fr2 (channels 22, 23)."""
    rec3, counts, nty = _lists(cuda)
    short = rec3[:, :22].contiguous()
    with pytest.raises(ValueError):
        cuda_backend.blend_tiles(short, counts, nty)
    out = cuda_backend.blend_tiles(rec3, counts, nty)
    grp = min(cuda_backend.GROUP, rec3.shape[2])
    off = cuda_backend._packed_offsets(counts, out, grp)
    with pytest.raises(ValueError):
        cuda_backend.blend_tiles_backward(short, counts, off, out, torch.zeros_like(out), nty,
                                          grp * rec3.shape[0])


def test_render_kernels_match_plain(cuda):
    cam, scene, settings = _scene(cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    out = api.render(cam, settings, *scene, bg)
    splats = preprocess.preprocess(*scene, cam, settings.width, settings.height, 3)
    image, allmap = cuda_backend.rasterize_cuda(splats, settings, bg, plain=True)
    ref = api.decode_outputs(cam, settings, splats, image, allmap)
    for k in ["render", "rend_alpha", "rend_normal", "rend_dist", "surf_depth",
              "depth_median"]:
        assert float((out[k] - ref[k]).abs().max()) <= 2e-4, k
    assert torch.equal(out["radii"], ref["radii"])


def _backward_matches_plain(rec3, counts, nty, room, row0=0):
    """Packed rows within 1e-3 of each row's largest value (the sum over a
    tile's pixels runs in another order), the slot column and the dropped
    groups exactly, two launches bit-equal, the scattered gradient within
    1e-4 of its largest."""
    dev = rec3.device
    out = cuda_backend.blend_tiles(rec3, counts, nty, row0)
    gen = torch.Generator(device=dev).manual_seed(0)
    dout = torch.randn(out.shape, device=dev, generator=gen)
    grp = min(cuda_backend.GROUP, rec3.shape[2])
    eff = cuda_backend._effective_counts(counts, out, grp)
    off = cuda_backend._packed_offsets(counts, out, grp)
    demand = int(eff.sum())
    pack_cap = demand + grp if room == "room" else max(grp, (demand // 2) // grp * grp)
    assert (pack_cap < demand) == (room == "overflow")
    before = native.LAUNCHES["blend_tiles_backward"]
    args = (rec3, counts, off, out, dout, nty, pack_cap, row0)
    got = cuda_backend.blend_tiles_backward(*args)
    again = cuda_backend.blend_tiles_backward(*args)
    ref = cuda_backend.blend_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["blend_tiles_backward"] == before + 2
    n = min(demand, pack_cap)
    assert torch.equal(got[:n].view(torch.int32), again[:n].view(torch.int32))
    assert torch.equal(got[:n, 19], ref[:n, 19])
    scale = ref[:n, :19].abs().amax(dim=1).clamp(min=1e-30)
    assert float(((got[:n, :19] - ref[:n, :19]).abs().amax(dim=1) / scale).max()) <= 1e-3
    k = int(rec3[:, 21].max()) + 1  # the record rows the id channel names
    gs = cuda_backend.scatter_packed(got, eff, k)
    rs = cuda_backend.scatter_packed(ref, eff, k)
    assert float((gs - rs).abs().max()) <= 1e-4 * float(rs.abs().max())
    with pytest.raises(ValueError):
        cuda_backend.blend_tiles_backward(rec3, counts, off, out, dout[:, :8], nty, pack_cap)


@pytest.mark.parametrize("room", ["room", "overflow"])
def test_backward_kernel_matches_plain(cuda, room):
    _backward_matches_plain(*_lists(cuda), room)


@pytest.mark.parametrize("room", ["room", "overflow"])
@pytest.mark.parametrize("case", ["empty_subtiles", "saturating"])
def test_backward_kernel_subtile_cases(cuda, case, room):
    _backward_matches_plain(*_crafted(cuda, case), room)


def test_training_step_launch_counts(cuda):
    """One training step: the select kernel three times, each blend kernel
    once; a render under no_grad: no backward launch."""
    w, h, n = 256, 96, 3000
    cams, model = synthetic.make_shell_training_set(w, h, n, views=2, device=cuda,
                                                    bin_capacity=2048, tile_capacity=1024)
    trainer = loop.Trainer(model, cams, w, h, spatial_lr_scale=1.0, scene_extent=1.0,
                           train_cfg=loop.TrainConfig(normal_from_iter=0, dist_from_iter=0,
                                                      lambda_dist=100.0),
                           raster_kwargs=dict(bin_capacity=2048, tile_capacity=1024))
    native.LAUNCHES.clear()
    trainer.train(num_iters=2)
    torch.cuda.synchronize()
    assert dict(native.LAUNCHES) == {"select_values": 6, "blend_tiles": 2,
                                     "blend_tiles_backward": 2}
    trainer.render_view(cams[0])
    assert native.LAUNCHES["blend_tiles_backward"] == 2 and native.LAUNCHES["blend_tiles"] == 3
    assert all(bool(torch.isfinite(p).all()) for p in trainer.model.params)
