"""tpu2dgs_torch's dataset harnesses (eval/{nerf,m360,dtu,tnt}_eval.py)
and eval/summary.py against the JAX package's scripts under scripts/.

The harnesses are held by the commands they run: the scripts run with
os.system and subprocess.call replaced by a recorder, the port's modules
with subprocess.run replaced by one, and the commands must be equal once
the module prefix, the interpreter and dtu_eval's results directory are
mapped. No stage runs and no dataset is read (none is in the repository).
Also: nerf_eval --parallel's GPU pinning, a failing stage raising, and
the summary table against the script's printed one, cell by cell, on a
generated tree. PyTorch runs on one thread, as in
tests/test_torch_oracle.py."""

import json
import os
import re
import shlex
import shutil
import subprocess
import sys
from unittest import mock

import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.eval import dtu_eval, m360_eval, nerf_eval, summary, tnt_eval

SCRIPTS = os.path.join(os.path.dirname(__file__), os.pardir, "scripts")
sys.path.insert(0, SCRIPTS)
import dtu_eval as jdtu  # noqa: E402
import m360_eval as jm360  # noqa: E402
import nerf_eval as jnerf  # noqa: E402
import summary as jsummary  # noqa: E402
import tnt_eval as jtnt  # noqa: E402

SCORERS = {"eval_dtu_scene.py": "tpu2dgs_torch.eval.dtu_scene",
           "eval_tnt_scene.py": "tpu2dgs_torch.eval.tnt_scene"}


def _script_commands(module, argv) -> list[str]:
    """The shell commands a script runs, in order."""
    cmds = []

    def record(cmd, shell=False):
        cmds.append(cmd)
        return 0

    with mock.patch.object(sys, "argv", ["script", *argv]), \
            mock.patch.object(os, "system", record), \
            mock.patch.object(subprocess, "call", record):
        module.main()
    return cmds


def _port_runs(module, argv) -> list[tuple[list[str], dict | None]]:
    """The argument lists (and environments) the port's module runs, in
    order, with two GPUs visible."""
    runs = []

    def record(cmd, check=False, env=None):
        assert check, "every stage's return code is checked"
        runs.append((list(cmd), env))
        return subprocess.CompletedProcess(cmd, 0)

    with mock.patch.object(subprocess, "run", record), \
            mock.patch.object(torch.cuda, "device_count", lambda: 2):
        module.main(argv, device="cpu")
    return runs


def _as_port(cmd: str, output_path: str) -> list[str]:
    """A script's command in the port's form: this interpreter, the
    port's modules, and dtu_eval's results under the scan's model."""
    toks = shlex.split(cmd)
    assert toks[0] == "python"
    if toks[1] == "-m":
        assert toks[2].startswith("tpu2dgs.")
        head, rest = [toks[2].replace("tpu2dgs.", "tpu2dgs_torch.", 1)], toks[3:]
    else:
        head, rest = [SCORERS[os.path.basename(toks[1])]], toks[2:]
    rest = [re.sub(r".*/tmp/scan(\d+)$", rf"{output_path}/scan\1", t) for t in rest]
    return [sys.executable, "-m", *head, *rest]


HARNESSES = {
    "nerf": (jnerf, nerf_eval, ["--nerf_synthetic", "/data/nerf", "--output_path", "out/nerf"]),
    "m360": (jm360, m360_eval, ["--mipnerf360", "/data/m360", "--output_path", "out/m360"]),
    "dtu": (jdtu, dtu_eval, ["--dtu", "/data/dtu", "--DTU_Official", "/data/DTU",
                             "--output_path", "out/dtu"]),
    "tnt": (jtnt, tnt_eval, ["--TNT_data", "/data/tnt", "--output_path", "out/tnt"]),
}


@pytest.mark.parametrize("name", sorted(HARNESSES))
def test_harness_commands_match_script(name, tmp_path):
    """Every stage of every scene, in the script's order, with the
    script's flags; the dtu scores land beside the scan's model. TnT's
    mapping file is passed where it exists (here for Barn only)."""
    jmod, tmod, argv = HARNESSES[name]
    if name == "tnt":
        gt = tmp_path / "gt"
        (gt / "Barn").mkdir(parents=True)
        (gt / "Barn" / "Barn_mapping_reference.txt").write_text("")
        argv = [*argv, "--TNT_GT", str(gt)]
    out = argv[argv.index("--output_path") + 1]
    want = [_as_port(c, out) for c in _script_commands(jmod, argv)]
    got = [cmd for cmd, _ in _port_runs(tmod, argv)]
    assert got == want
    assert len(got) == {"nerf": 17, "m360": 19, "dtu": 45, "tnt": 18}[name]
    if name == "dtu":
        outs = [c[c.index("--output_dir") + 1] for c in got if "--output_dir" in c]
        assert outs == [f"{out}/{s}" for s in dtu_eval.SCANS]
    if name == "tnt":
        maps = [c for c in got if "--map-file" in c]
        assert len(maps) == 1 and "Barn/Barn_mapping_reference.txt" in maps[0][-1]


def test_parallel_jobs_pinned_and_failures_raise(monkeypatch):
    """nerf_eval --parallel 2 pins training job i to GPU i mod 2 (the
    script's pool sets no device); a list the caller set is the pool. A
    stage that fails raises and names its command (the scripts' os.system
    goes on to the next stage)."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    argv = ["--nerf_synthetic", "/data/nerf", "--parallel", "2", "--skip_rendering",
            "--skip_metrics"]
    runs = _port_runs(nerf_eval, argv)
    pins = {cmd[cmd.index("-s") + 1].rsplit("/", 1)[1]: env["CUDA_VISIBLE_DEVICES"]
            for cmd, env in runs}
    assert pins == {s: str(i % 2) for i, s in enumerate(nerf_eval.SCENES)}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    runs = _port_runs(nerf_eval, argv)
    assert sorted(env["CUDA_VISIBLE_DEVICES"] for _, env in runs) == ["3"] * 4 + ["5"] * 4

    false = [shutil.which("false")]
    with mock.patch.object(m360_eval, "TRAIN", false), \
            pytest.raises(subprocess.CalledProcessError, match="bicycle"):
        m360_eval.main(["--mipnerf360", "/data/m360"], device="cpu")
    with mock.patch.object(nerf_eval, "TRAIN", false), \
            pytest.raises(subprocess.CalledProcessError, match="chair"):
        nerf_eval.main(["--nerf_synthetic", "/data/nerf", "--skip_rendering"], device="cpu")


def _parse(text: str) -> tuple[list[str], dict[str, list[str]]]:
    """(columns, {row: cells}) of a printed table."""
    lines = text.strip().splitlines()
    columns = lines[0].split()
    rows = {}
    for line in lines[1:]:
        name, *cells = line.split()
        assert len(cells) == len(columns), line
        rows[name] = cells
    return columns, rows


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


def _tables(root, capsys):
    with mock.patch.object(sys, "argv", ["summary", "-o", str(root)]):
        jsummary.main()
    script = _parse(capsys.readouterr().out)
    summary.main(["-o", str(root)])
    return script, _parse(capsys.readouterr().out)


def test_summary_matches_script(tmp_path, capsys):
    """Image metrics (LPIPS null: left out), a TnT f1.json and a DTU
    results.json: the port's table equals the script's DataFrame cell by
    cell, mean row included. With `ours_30000` and `ours_7000` both in a
    results.json the script takes ours_7000 (the last name sorted) and the
    port ours_30000 (the highest iteration)."""
    _write(tmp_path / "bicycle" / "results.json",
           {"ours_30000": {"SSIM": 0.81234567, "PSNR": 25.123456, "LPIPS": None}})
    _write(tmp_path / "garden" / "results.json",
           {"ours_30000": {"SSIM": 0.7, "PSNR": 27.5, "LPIPS": 0.125}})
    _write(tmp_path / "Barn" / "f1.json",
           {"precision": 0.5, "recall": 0.25, "f1": 1 / 3, "tau": 0.01})
    _write(tmp_path / "scan24" / "results.json",
           {"mean_d2s": 0.7, "mean_s2d": 0.9, "overall": 0.8})
    (tmp_path / "empty").mkdir()
    (tmp_path / "notes.txt").write_text("not a scene")
    script, port = _tables(tmp_path, capsys)
    assert port == script
    assert list(port[1]) == ["Barn", "bicycle", "garden", "scan24", "mean"]
    assert port[1]["mean"][port[0].index("PSNR")] == f"{(25.123456 + 27.5) / 2:.4f}"

    _write(tmp_path / "room" / "results.json",
           {"ours_30000": {"SSIM": 0.9, "PSNR": 31.0}, "ours_7000": {"SSIM": 0.6, "PSNR": 22.0}})
    script, port = _tables(tmp_path, capsys)
    assert port[0] == script[0]
    psnr = port[0].index("PSNR")
    assert script[1]["room"][psnr] == "22.0000" and port[1]["room"][psnr] == "31.0000"
    assert {k: v for k, v in port[1].items() if k not in ("room", "mean")} == \
        {k: v for k, v in script[1].items() if k not in ("room", "mean")}
    assert port[1]["mean"][psnr] == f"{(25.123456 + 27.5 + 31.0) / 3:.4f}"
