"""Time the select kernels against another version of their sources in one
process, in turns.

    python3 -m tpu2dgs_torch.eval.select_turns OTHER_CSRC

OTHER_CSRC is another version of the directory tpu2dgs_torch/csrc, with
its headers (the kernels include hit_test.cuh from beside them), e.g. a
parent commit's: `git archive <commit> tpu2dgs_torch/csrc | tar -x -C
.smoke/other`. Its select_values.cu and select_counts.cu are built with the
port's flags into libraries beside them (`native.build_other`). On the
bench scene's levels (`bin_probe.levels`: 800x800, 131,072 splats, the
bench capacities) each kernel is timed alone (`bin_probe.alone_ms`: 200
launches queued behind a spin kernel) in turns, other, this tree's, this
tree's, other, so that a drift of the card's clocks shows in the turns:
the select kernel (K1) at L1, L2 and L3, the count kernel (K4) at L2 and
L3. Both sides must give the same counts, and K1 the same bits. Prints one
JSON line a kernel and level, then each side's ptxas lines and the card.

The other select_values.cu takes this tree's launcher arguments. The other
select_counts.cu has either this tree's launcher (with
`select_counts_occupancy`, tickets and scratch) or the earlier one, which
splits each row over a fixed number of blocks and zeroes the counts before
its kernel. Runs on the GPU and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
from pathlib import Path
from unittest import mock

import torch

from tpu2dgs_torch.eval import bin_probe
from tpu2dgs_torch.eval.timing import card
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import select_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
# The earlier count launcher: its arguments, and the blocks it aimed to keep
# in flight, over which its wrapper split each row.
_SPLIT_ARGTYPES = [_P] * 8 + [_I] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2 + [_I, _P]
_SPLIT_BLOCKS = 4 * 132


def _has_tickets(lib: ctypes.CDLL) -> bool:
    """Is lib's count launcher this tree's kind (tickets), or the earlier one?"""
    return hasattr(lib, "select_counts_occupancy")


def _bind(lib: ctypes.CDLL, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def other_kernels(libs: dict[str, ctypes.CDLL]):
    """select_kernel's wrappers launch the kernels of `libs` (by source
    name), with their own occupancy and ticket buffers; an earlier count
    launcher goes through `split_count_launch`."""
    count_launch = (select_kernel._count_launch if _has_tickets(libs["select_counts"])
                    else split_count_launch(libs["select_counts"]))
    with mock.patch.object(native, "function",
                           lambda name, symbol, argtypes: _bind(libs[name], symbol, argtypes)), \
            mock.patch.object(select_kernel, "_OCCUPANCY", {}), \
            mock.patch.object(select_kernel, "_COUNT_OCCUPANCY", {}), \
            mock.patch.object(select_kernel, "_TICKETS", {}), \
            mock.patch.object(select_kernel, "_count_launch", count_launch):
        yield


def split_count_launch(lib: ctypes.CDLL):
    """`select_kernel._count_launch` for the earlier count launcher of
    `lib`, with that launcher's wrapper's split."""
    fn = _bind(lib, "select_counts_launch", _SPLIT_ARGTYPES)

    def launch(rects, stacked, parent, pcnt, box_idx, exact_idx):
        dev = stacked.device
        r = rects[0].shape[0]
        _, n_chan, m = stacked.shape
        counts = torch.empty((r,), dtype=torch.int32, device=dev)  # the launcher zeroes it
        box, exact = select_kernel._test_indices(box_idx, exact_idx)
        splits = max(1, min(m // 256, -(-_SPLIT_BLOCKS // max(r, 1))))
        native.check(fn(stacked.data_ptr(), parent.data_ptr(), pcnt.data_ptr(),
                        *(a.data_ptr() for a in rects), counts.data_ptr(), r, n_chan, m,
                        splits, box, exact, dev.index or 0,
                        torch.cuda.current_stream(dev).cuda_stream),
                     what="other select_counts launch")
        return counts

    return launch


def ptxas_lines(log: Path) -> list[str]:
    """nvcc's report of registers, shared memory and spills, per kernel."""
    return [line.split(":", 1)[-1].strip() for line in log.read_text().splitlines()
            if "registers" in line or "spill" in line]


@torch.no_grad()
def run(other: Path) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the select turns time CUDA kernels: they need a GPU")
    dev = torch.device("cuda")
    libs = {name: native.build_other(other / f"{name}.cu")
            for name in ("select_values", "select_counts")}

    def on_other(fn):
        with other_kernels(libs):
            return fn()

    out = {}
    for level, (kw, cap, (chans, counts)) in bin_probe.levels(dev).items():
        o_chans, o_counts = on_other(lambda: select_kernel.select_values(cap=cap, **kw))
        if not (torch.equal(o_counts, counts)
                and torch.equal(o_chans.view(torch.int32), chans.view(torch.int32))):
            raise RuntimeError(f"select_values {level}: the other kernel's output differs")
        k1 = lambda: bin_probe.alone_ms(select_kernel._launch, kw, cap)  # noqa: E731
        rows = [("select_values", lambda: on_other(k1), k1)]
        if level != "L1":
            ckw = {k: v for k, v in kw.items() if k != "cap"}
            for name, got in (("this tree's", select_kernel.select_counts(**ckw)),
                              ("the other", on_other(lambda: select_kernel.select_counts(**ckw)))):
                if not torch.equal(got, counts):
                    raise RuntimeError(f"select_counts {level}: {name} kernel's counts "
                                       "differ from select_values'")
            # select_kernel._count_launch looked up at the call: the other's under on_other
            k4 = lambda: bin_probe.alone_ms(select_kernel._count_launch, ckw)  # noqa: E731
            rows.append(("select_counts", lambda: on_other(k4), k4))
        for name, other_ms, change_ms in rows:
            turns = [t() for t in (other_ms, change_ms, change_ms, other_ms)]
            res = dict(level=level, ms=(turns[1] + turns[2]) / 2,
                       other_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)
            out.setdefault(name, {})[level] = res
            print(json.dumps({"select_turns": name, **res}), flush=True)
    count_kind = "tickets" if _has_tickets(libs["select_counts"]) else "split"
    out["ptxas"] = {name: {"this": ptxas_lines(native.library_path(name).with_suffix(".log")),
                           "other": ptxas_lines(other / f"lib{name}_other.log")}
                    for name in libs}
    out["other_count_launcher"] = count_kind
    print(json.dumps({"ptxas": out["ptxas"], "other_count_launcher": count_kind}), flush=True)
    print(json.dumps({"card": card()}), flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another version of tpu2dgs_torch/csrc")
    run(parser.parse_args(argv).other.resolve())


if __name__ == "__main__":
    main()
