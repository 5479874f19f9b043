"""The reduction probe's K6 operand split and the probes' entry points,
plain, on the CPU; no JAX: reduce_probe_mma's three-way split of each
float32 term into bfloat16 parts is exact, and bin_probe and
reduce_probe refuse to run without a GPU."""

import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.eval import bin_probe, reduce_probe


def _top16(a: torch.Tensor) -> torch.Tensor:
    """float32 with its low 16 bits cleared, as the kernel masks them."""
    return (a.view(torch.int32) & -65536).view(torch.float32)


def _pack_top_halves(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """__byte_perm(a, b, 0x7632): a's top half low, b's high, as int32."""
    return (b.view(torch.int32) & -65536) | ((a.view(torch.int32) >> 16) & 0xFFFF)


def _bfloat16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a and b converted to bfloat16 and read as one int32 (a low)."""
    return torch.stack([a.bfloat16(), b.bfloat16()], dim=-1).view(torch.int32)[..., 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_three_way_split_is_exact_in_bfloat16(seed):
    """reduce_probe_mma's split (csrc/reduce_probe.cu): every plane value
    p = fma(base, f, f) is hi + mid + lo bit for bit, each part is its own
    top 16 bits, so the byte permute that packs a pair of rows (the even
    row low, as the m16n8k16 A fragment holds them) into an operand is the
    parts' bfloat16 conversion, with nothing rounded."""
    base = reduce_probe.probe_input(seed, "cpu").double()
    for s in (0, 1, 255, 511):
        f = (s * 16 + 1 + torch.arange(16, dtype=torch.float64))[:, None, None]
        p = (base * f + f).float()  # exact in float64, so one rounding: __fmaf_rn's
        hi = _top16(p)
        rem = p - hi
        mid = _top16(rem)
        lo = rem - mid
        assert torch.equal(((hi + mid) + lo).view(torch.int32), p.view(torch.int32))
        for part in (hi, mid, lo):
            assert not bool((part.view(torch.int32) & 0xFFFF).any())
        # the kernel packs p, rem and lo; their top halves are hi, mid, lo
        for packed, part in ((p, hi), (rem, mid), (lo, lo)):
            got = _pack_top_halves(packed[:, 0::2], packed[:, 1::2])
            assert torch.equal(got, _bfloat16_pair(part[:, 0::2], part[:, 1::2]))


@pytest.mark.parametrize("probe", [bin_probe, reduce_probe])
def test_probes_need_a_gpu(probe, monkeypatch):
    """The probe entry points time kernels on the card: no card, no run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])
    with pytest.raises(RuntimeError, match="needs a GPU"):
        probe.run(device="cpu")
