"""tpu2dgs_torch command-line configuration against tpu2dgs: cfg_args
written by the port, by the JAX package's save_cfg_args and by hand, read
by both; the backend names; every flag of the JAX parsers' test; and the
arguments cli.train refuses before it writes anything. The pipeline
itself is tests/test_torch_cli.py's."""

import argparse

import pytest
import torch

from tests.test_data import _make_colmap_dataset
from tests.test_torch_cli import TRAIN_FLAGS
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.cli import config as jcfg
from tpu2dgs_torch.cli import config as tcfg
from tpu2dgs_torch.cli import convert as tcli_convert
from tpu2dgs_torch.cli import render as tcli_render
from tpu2dgs_torch.cli import train as tcli_train

MODEL_NS = dict(sh_degree=3, source_path="/data/lego", model_path="", images="images",
                resolution=2, white_background=True, data_device="cuda", eval=True)


@pytest.mark.parametrize("writer", ["port", "jax", "reference"])
def test_cfg_args_read_by_port(tmp_path, writer):
    ns = argparse.Namespace(**{**MODEL_NS, "model_path": str(tmp_path)}, iterations=7)
    if writer == "port":
        tcfg.save_cfg_args(str(tmp_path), ns)
    elif writer == "jax":
        jcfg.save_cfg_args(str(tmp_path), ns)
    else:
        (tmp_path / "cfg_args").write_text(
            "Namespace(data_device='cuda', eval=True, images='images', "
            f"model_path='{tmp_path}', resolution=2, sh_degree=3, "
            "source_path='/data/lego', white_background=True)")
    loaded = tcfg.load_cfg_args(str(tmp_path))
    assert vars(loaded) == {**MODEL_NS, "model_path": str(tmp_path)}
    # both packages write the same file, so it passes both ways
    assert vars(jcfg.load_cfg_args(str(tmp_path))) == vars(loaded)
    merged = tcfg.get_combined_args(tcli_render.build_parser(),
                                    ["-m", str(tmp_path), "--skip_mesh", "-r", "4"])
    assert merged.source_path == "/data/lego" and merged.eval is True
    assert merged.resolution == 4  # the command line wins over the file
    assert tcfg.extract(tcfg.RasterParams, merged).backend == "cuda"


def test_backend_names(tmp_path, capsys):
    assert tcfg.RasterParams().backend == "cuda"
    assert tcfg.port_backend("cuda") == "cuda"
    assert tcfg.port_backend("pallas") == "cuda"
    assert '"pallas"' in capsys.readouterr().out  # the CLI says that it did so
    for name in ("tiled", "oracle"):  # the JAX package's default and its spec
        assert tcfg.port_backend(name) == name
    with pytest.raises(ValueError):
        tcfg.port_backend("vulkan")
    # a hand-written cfg_args that names the JAX package's backend
    (tmp_path / "cfg_args").write_text("Namespace(backend='pallas', sh_degree=3)")
    assert tcfg.load_cfg_args(str(tmp_path)).backend == "cuda"
    (tmp_path / "cfg_args").write_text("not a namespace")
    with pytest.raises(ValueError):
        tcfg.load_cfg_args(str(tmp_path))


def test_parsers_accept_the_jax_flags():
    """Every flag tests/test_cli.py gives the JAX parser, and every option
    the JAX parsers define, parses in the port with the same default."""
    args = tcli_train.build_parser().parse_args([
        "-s", "/data/x", "-m", "/out/y", "-r", "2", "-w", "--iterations", "7000",
        "--lambda_dist", "1000", "--depth_ratio", "1", "--eval"])
    assert (args.source_path, args.resolution, args.white_background) == ("/data/x", 2, True)
    assert (args.iterations, args.lambda_dist, args.depth_ratio) == (7000, 1000.0, 1.0)

    from tpu2dgs.cli import render as jcli_render
    from tpu2dgs.cli import train as jcli_train

    for jparser, tparser in ((jcli_train.build_parser(), tcli_train.build_parser()),
                             (jcli_render.build_parser(), tcli_render.build_parser())):
        jopts = {a.dest: a for a in jparser._actions}
        topts = {a.dest: a for a in tparser._actions}
        assert set(jopts) == set(topts)
        for dest, ja in jopts.items():
            assert set(ja.option_strings) == set(topts[dest].option_strings), dest
            if dest != "backend":  # "tiled" there; "cuda" here, or cfg_args' in render
                assert ja.default == topts[dest].default, dest


def test_unported_arguments_raise(tmp_path, monkeypatch):
    """--n_devices N runs (tile rows, tests/test_torch_sharded.py; splats,
    tests/test_torch_splat_sharded.py) and refuses what it cannot run
    before anything is written: more ranks than GPUs, 0 (every GPU) on the
    CPU, and splat sharding off the cuda backend."""
    base = ["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--disable_viewer"]
    with pytest.raises(ValueError, match="--shard_mode splats needs the cuda backend"):
        tcli_train.main(base + ["--n_devices", "2", "--shard_mode", "splats", "--backend",
                                "tiled"], device="cpu")
    with pytest.raises(ValueError, match="counts GPUs"):
        tcli_train.main(base + ["--n_devices", "0"], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcli_train.main(base + ["--n_devices", "2"])  # the GPU run, where there is none
    with monkeypatch.context() as m:  # one GPU: no fallback to fewer ranks
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs; this host has 1"):
            tcli_train.main(base + ["--n_devices", "2"])
    assert not (tmp_path / "out").exists()  # refused before anything was written
    # --shard_mode splats with one rank trains unsharded, as in the JAX package
    scene = tmp_path / "scene"
    scene.mkdir()
    _make_colmap_dataset(str(scene), n_views=6, n_pts=40)
    one = tcli_train.main(["-s", str(scene), "-m", str(tmp_path / "one"), "--shard_mode",
                           "splats", *TRAIN_FLAGS, "--iterations", "1"], device="cpu")
    assert one.step == 1 and not one.shard_splats and one.model.capacity == 4096
    assert tcli_convert.main.__defaults__ == (None, None)  # main(argv=None, device=None)
