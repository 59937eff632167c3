"""``python -m rtgs_tpu_torch.probes.ring --train`` at a toy size: two gloo
ranks under the port's launcher, meshes 2×1 and 1×2, each frame equal to
the single-device keys render, each mesh's gradients bitwise the
single-device path's, and two sharded training steps on each mesh bitwise
the one-device steps, at both of ``--train``'s configurations (scenes of
256 splats, whose shards of 128 rows end in no vector tail of the CPU's
sigmoid; see tests/test_torch_parallel.py)."""

import os
import pathlib
import re
import sys

from rtgs_tpu_torch.parallel.launcher import launch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_ring_probe_two_ranks(tmp_path, capfd):
    cmd = [sys.executable, "-m", "rtgs_tpu_torch.probes.ring", "--device",
           "cpu", "--n", "400", "--res", "32,32", "--cand", "512",
           "--bands", "2", "--meshes", "2x1,1x2", "--grad-meshes", "2x1,1x2",
           "--grad-n", "256", "--grad-res", "32,32", "--grad-cand", "512",
           "--train", "--steps", "2", "--dry-n", "256", "--dry-res", "32,32"]
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
    for shape in ("2x1", "1x2"):
        grads = re.search(rf"ring {shape} scene gradients.*", out).group(0)
        assert "bitwise equal in every field on every rank" in grads, grads
        sent = re.search(r"the backward sends (\d+) bytes", grads)
        # 2×1: each rays-rank sends its tiles' records to the other, which
        # holds the same shard; 1×2: each sends the other shard's records.
        assert sent and int(sent.group(1)) > 0, grads
    steps = re.findall(r"sharded step (\S+) at .*", out)
    assert steps == ["2x1", "1x2"] * 2, out
    assert out.count("(one device drops 0 pairs): 2 steps bitwise the "
                     "one-device keys steps") == 4, out
