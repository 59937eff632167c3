"""``python -m rtgs_tpu_torch.probes.ring`` at a toy size: two gloo ranks
under the port's launcher, meshes 2×1 and 1×2, each frame equal to the
single-device keys render and the 1×2 ring's gradients equal to the
single-device path's (both with deterministic algorithms, on the CPU the
same sums in the same order)."""

import os
import pathlib
import re
import sys

from rtgs_tpu_torch.parallel.launcher import launch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_ring_probe_two_ranks(tmp_path, capfd):
    cmd = [sys.executable, "-m", "rtgs_tpu_torch.probes.ring", "--device",
           "cpu", "--n", "400", "--res", "32,32", "--cand", "512",
           "--bands", "2", "--meshes", "2x1,1x2", "--grad-mesh", "1x2",
           "--grad-n", "300", "--grad-res", "32,32", "--grad-cand", "512"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    # A file store keeps parallel test workers off each other's ports.
    rc = launch(cmd + ["--init", f"file://{tmp_path}/store"],
                num_processes=2, coordinator="localhost:0", env=env)
    out = capfd.readouterr().out
    assert rc == 0, out
    assert "0 candidates dropped" in out
    for shape in ("2x1", "1x2"):
        m = re.search(rf"ring {shape}: max \|ring − keys\| (\S+) ", out)
        assert m and float(m.group(1)) == 0.0, out
    grads = re.search(r"ring 1x2 scene gradients.*", out).group(0)
    assert grads.count("q99 0.0e+00 max 0.0e+00") == 6, grads
