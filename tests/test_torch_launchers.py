"""The port's shell launchers (``gnnflow_tpu_torch/scripts/run_*.sh``):
one tiny CPU run of ``run_offline.sh`` from a copy of the package (so
that its checkpoint lands in the copy), a failing run of
``run_multiprocess.sh ... all`` beside it (each rank's lines prefixed,
exit 1), and ``bash -n`` on all three."""
import os
import shutil
import signal
import subprocess
import sys

import pytest

from gnnflow_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "gnnflow_tpu_torch", "scripts")
LAUNCHERS = ("run_offline.sh", "run_partitioned.sh", "run_multiprocess.sh")


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_parses_and_sets_no_tpu_flags(name):
    path = os.path.join(SCRIPTS, name)
    subprocess.run(["bash", "-n", path], check=True)
    with open(path) as f:
        text = f.read()
    assert "XLA_FLAGS" not in text and "--platform" not in text
    assert "python}\" -m gnnflow_tpu_torch.scripts." in text


def test_run_offline_on_cpu_and_multiprocess_status(tmp_path):
    copy = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "gnnflow_tpu_torch"),
                    copy / "gnnflow_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # the helper's library, as the copy would build it
    lib = _build.build_host("ingest")
    os.makedirs(copy / "build")
    shutil.copy(lib, copy / "build")
    env = dict(os.environ, PYTHON=sys.executable, OMP_NUM_THREADS="1")
    scripts = copy / "gnnflow_tpu_torch" / "scripts"
    # each launcher leads its own process group, so that a run cut by its
    # timeout leaves no rank or interpreter behind
    run = dict(cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
               stderr=subprocess.STDOUT, text=True, start_new_session=True)
    started = []
    try:
        offline = subprocess.Popen(
            ["bash", str(scripts / "run_offline.sh"), "GRAPHSAGE",
             "SYNTHETIC", "--epoch", "1", "--synthetic-edges", "1500",
             "--synthetic-dim-edge", "8", "--device", "cpu"], **run)
        started.append(offline)
        ranks = subprocess.Popen(
            ["bash", str(scripts / "run_multiprocess.sh"), "TGN",
             "SYNTHETIC", "2", "all", "localhost:1", "--device", "cpu",
             "--no-such-flag"], **run)
        started.append(ranks)
        out = offline.communicate(timeout=120)[0]
        failed = ranks.communicate(timeout=120)[0]
    finally:
        for p in started:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    assert offline.returncode == 0, out[-3000:]
    assert "Test ap" in out
    assert (copy / "GRAPHSAGE_torch.ckpt").exists()
    assert ranks.returncode == 1, failed[-3000:]
    lines = failed.splitlines()
    assert lines and all(ln[:4] in ("[p0]", "[p1]") for ln in lines)
    assert {ln[:4] for ln in lines if "--no-such-flag" in ln} \
        == {"[p0]", "[p1]"}
