"""tpu2dgs_torch CUDA kernels vs their plain PyTorch versions, on the GPU.

Marked `cuda`: each test skips without a CUDA device. The file imports
nothing of JAX, so it also runs where JAX is not installed; from the repo
root on the machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import api, binning, cuda_backend, preprocess, select_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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


SELECT_CASES = {
    "box": lambda dev: _box_case(dev, 512),
    "box_overflow": lambda dev: _box_case(dev, 128),
    "exact_rec_pads": _exact_case,
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_kernel_bit_equal(cuda, case):
    kw = SELECT_CASES[case](cuda)
    before = native.LAUNCHES["select_values"]
    got, cnt = select_kernel.select_values(**kw)
    ref, ref_cnt = select_kernel.select_values_plain(**kw)
    torch.cuda.synchronize()
    assert native.LAUNCHES["select_values"] == before + 1
    assert torch.equal(cnt, ref_cnt)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _scene(dev, w=256, h=96, n=3000):
    cam, scene = synthetic.make_bench_scene(w, h, n, device=dev)
    return cam, scene, api.RasterSettings(w, h, bin_capacity=1024, tile_capacity=384)


def test_blend_kernel_matches_plain(cuda):
    cam, scene, settings = _scene(cuda)
    splats = preprocess.preprocess(*scene, cam, settings.width, settings.height, 3)
    comp = binning.compact_visible(splats, scene[0].shape[0])
    rec = cuda_backend.pack_records(splats)
    nbx, nty = -(-settings.width // 128), -(-settings.height // 16)
    rec3, raw, _, _ = cuda_backend._bin_records(
        comp.x0, comp.x1, comp.y0, comp.y1, comp.num_visible, rec, nbx, nty, 1024, 384,
        ids=comp.perm)
    counts = torch.clamp(raw, max=rec3.shape[2]).to(torch.int32)
    got = cuda_backend.blend_tiles(rec3, counts, nty)
    ref = cuda_backend.blend_tiles_plain(rec3, counts, nty)
    torch.cuda.synchronize()
    assert float((got[:, :12] - ref[:, :12]).abs().max()) <= 1e-5
    assert float((got[:, 12] != ref[:, 12]).float().mean()) <= 1e-4


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
