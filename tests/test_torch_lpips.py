"""tpu2dgs_torch's LPIPS against tpu2dgs's, on one seeded npz of random
VGG16 and linear-head weights (the released ones are not in the
repository), and cli.metrics' LPIPS column: the per-view values against the
JAX function, null where the weights file is missing, and an error, not
null, where the file is there but broken.

The JAX side compiles LPIPS at 32x32 once. PyTorch runs on one thread, as
in tests/test_torch_oracle.py."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.eval import lpips as jlpips
from tpu2dgs_torch.cli import metrics as tcli_metrics
from tpu2dgs_torch.data.paths import save_img_u8
from tpu2dgs_torch.eval import lpips as tlpips

RES = 32


@pytest.fixture(scope="module")
def weights_path(tmp_path_factory):
    """Random weights in the converter's npz layout, as tests/test_lpips.py
    makes them, with nonzero biases so that the bias path is held too."""
    rng = np.random.default_rng(0)
    arrays, in_ch = {}, 3
    idx = 0
    for out_ch, n_convs in jlpips._VGG_BLOCKS:
        for _ in range(n_convs):
            arrays[f"conv{idx}_w"] = rng.normal(scale=0.05, size=(out_ch, in_ch, 3, 3)
                                                ).astype(np.float32)
            arrays[f"conv{idx}_b"] = rng.normal(scale=0.01, size=out_ch).astype(np.float32)
            in_ch = out_ch
            idx += 1
    for i, (ch, _) in enumerate(jlpips._VGG_BLOCKS):
        arrays[f"lin{i}_w"] = np.abs(rng.normal(size=ch)).astype(np.float32)
    path = tmp_path_factory.mktemp("lpips") / "w.npz"
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def jax_lpips(weights_path):
    return jlpips.lpips_fn(weights_path)


def test_lpips_matches_jax(weights_path, jax_lpips):
    rng = np.random.default_rng(1)
    a, b = (rng.random((3, RES, RES)).astype(np.float32) for _ in range(2))
    fn = tlpips.lpips_fn(weights_path, device="cpu")
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == () and got.dtype == torch.float32 and got.device.type == "cpu"
    want = float(jax_lpips(jnp.asarray(a), jnp.asarray(b)))
    assert float(got) == pytest.approx(want, rel=1e-4), (float(got), want)
    assert float(fn(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(0.0, abs=1e-6)
    assert float(fn(torch.from_numpy(b), torch.from_numpy(a))) == pytest.approx(float(got),
                                                                              rel=1e-5)
    with pytest.raises(RuntimeError, match="CUDA"):  # no GPU here: no fallback
        tlpips.lpips_fn(weights_path)


def test_weights_path_and_missing_message(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU2DGS_LPIPS_WEIGHTS", raising=False)
    assert tlpips.default_weights_path().endswith("tpu2dgs_torch/eval/weights/lpips_vgg.npz")
    monkeypatch.setenv("TPU2DGS_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    assert tlpips.default_weights_path() == str(tmp_path / "w.npz")
    with pytest.raises(FileNotFoundError, match="LPIPS weights not found"):
        tlpips.load_weights()


def _model_dir(root, n_views=2):
    """A model directory as cli.render leaves it: test/ours_7/{renders,gt}."""
    rng = np.random.default_rng(2)
    method = root / "test" / "ours_7"
    for sub in ("renders", "gt"):
        (method / sub).mkdir(parents=True)
    for k in range(n_views):
        gt = rng.random((RES, RES, 3)).astype(np.float32)
        render = np.clip(gt + rng.normal(scale=0.1, size=gt.shape), 0, 1).astype(np.float32)
        save_img_u8(gt, str(method / "gt" / f"{k:05d}.png"))
        save_img_u8(render, str(method / "renders" / f"{k:05d}.png"))
    return method


@pytest.mark.parametrize("weights", ["present", "missing", "broken"])
def test_cli_metrics_lpips(weights, weights_path, jax_lpips, tmp_path, monkeypatch, capsys):
    """With the weights, LPIPS per view equals the JAX function's on the
    same PNGs; without the file, the command says LPIPS is unavailable and
    writes null; a file that is there but lacks a layer is an error."""
    method = _model_dir(tmp_path)
    if weights == "broken":
        z = dict(np.load(weights_path))
        del z["conv12_w"]
        path = tmp_path / "broken.npz"
        np.savez(path, **z)
    else:
        path = weights_path if weights == "present" else tmp_path / "none.npz"
    monkeypatch.setenv("TPU2DGS_LPIPS_WEIGHTS", str(path))
    if weights == "broken":
        with pytest.raises(KeyError, match="conv12_w"):
            tcli_metrics.main(["-m", str(tmp_path)], device="cpu")
        return
    tcli_metrics.main(["-m", str(tmp_path)], device="cpu")
    results = json.loads((tmp_path / "results.json").read_text())["ours_7"]
    per_view = json.loads((tmp_path / "per_view.json").read_text())["ours_7"]
    assert np.isfinite(results["PSNR"]) and np.isfinite(results["SSIM"])
    if weights == "missing":
        assert results["LPIPS"] is None and per_view["LPIPS"] == {}
        assert "LPIPS unavailable: LPIPS weights not found" in capsys.readouterr().out
        return
    names = sorted(p.name for p in (method / "renders").iterdir())
    assert sorted(per_view["LPIPS"]) == names
    for name in names:
        r, g = (jnp.asarray(tcli_metrics._load_image_chw(str(method / sub / name)))
                for sub in ("renders", "gt"))
        assert per_view["LPIPS"][name] == pytest.approx(float(jax_lpips(r, g)), rel=1e-4)
    assert results["LPIPS"] == pytest.approx(np.mean(list(per_view["LPIPS"].values())),
                                             rel=1e-6)
