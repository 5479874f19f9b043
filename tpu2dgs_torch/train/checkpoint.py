"""Full-training-state checkpointing (port of tpu2dgs/train/checkpoint.py).

The state is a flat npz of the SplatModel, the AdamState and host
counters, under the JAX package's keys, so a checkpoint written by either
package resumes in the other:

    model.live, model.max_radii2d, model.grad_accum, model.denom,
    model.params/<field>, adam.mu/<field>, adam.nu/<field>, adam.count,
    step, extra.<name>

The file is written to a temporary name and renamed, so a reader never
sees half a checkpoint. The PLY (model/splats.py) remains the
interchange format for a trained model; this is the resume format.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from tpu2dgs_torch.model import convert
from tpu2dgs_torch.model.optim import AdamState
from tpu2dgs_torch.model.splats import STATS, SplatModel, SplatParams


def save_checkpoint(path: str, model: SplatModel, adam: AdamState, step: int,
                    extra: dict[str, Any] | None = None) -> None:
    state = convert.state_to_numpy(model, adam)
    arrays = {
        "model.live": state["live"],
        **{f"model.{k}": state["stats"][k] for k in STATS},
        # the JAX package keeps the count as a 0-d int32 array
        "adam.count": np.asarray(state["adam"]["count"], np.int32),
        "step": np.asarray(step),
    }
    for prefix, fields in (("model.params/", state["params"]),
                           ("adam.mu/", state["adam"]["mu"]),
                           ("adam.nu/", state["adam"]["nu"])):
        arrays.update({prefix + name: a for name, a in fields.items()})
    for k, v in (extra or {}).items():
        arrays["extra." + k] = np.asarray(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None):
    """Returns (model, adam, step, extra_dict), the tensors on `device`
    (default: the GPU)."""
    with np.load(path) as z:
        def fields(prefix):
            return {name: z[prefix + name] for name in SplatParams._fields}

        state = {
            "params": fields("model.params/"),
            "live": z["model.live"],
            "stats": {k: z[f"model.{k}"] for k in STATS},
            "adam": {"count": int(z["adam.count"]), "mu": fields("adam.mu/"),
                     "nu": fields("adam.nu/")},
        }
        step = int(z["step"])
        extra = {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}
    model, adam = convert.state_from_numpy(state, device=device)
    return model, adam, step, extra
