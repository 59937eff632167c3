"""The checkout-against-checkout probe (rtgs_tpu_torch/probes/samebits.py)
on the CPU, through the plain twins at its SMALL scene: a dump repeats bit
for bit, also when the script runs as a file on a ``--root``, and a
comparison names what differs."""

import pathlib
import subprocess
import sys

import pytest
import torch

from rtgs_tpu_torch.probes import samebits

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "rtgs_tpu_torch" / "probes" / "samebits.py"


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    path = tmp_path_factory.mktemp("samebits") / "a.pt"
    res = samebits.dump(path, torch.device("cpu"), configs=samebits.SMALL,
                        iters=1)
    return path, res


def test_dump_holds_every_output_and_no_launch_on_the_cpu(dumped):
    _, res = dumped
    label = samebits.SMALL[0][0]
    for depth in samebits.DEPTHS:
        for name, fields in (("keys", ("t1", "sid")),
                             ("fused", ("rad", "trans", "grad")),
                             ("topk", ("t1", "alpha", "r", "g", "b",
                                       "grad"))):
            for f in fields:
                x = res["tensors"][f"{label}/d{depth}/{name}/{f}"]
                assert x.device.type == "cpu"
                if x.is_floating_point() and f != "t1":
                    assert bool(torch.isfinite(x).all())
            made = res["launches"][f"{label}/d{depth}/{name}"]
            assert set(made) == set(samebits.KERNELS)
            assert not any(made.values())
        grad = res["tensors"][f"{label}/d{depth}/fused/grad"]
        assert float(grad.abs().max()) > 0
        sid = res["tensors"][f"{label}/d{depth}/keys/sid"]
        assert sid.shape[1] == depth and bool((sid >= 0).any())
        for name, fields in (
                ("render", ["image"] + [f"grad_{f}" for f in
                                        samebits.SCENE_FIELDS]),
                ("steps", [f"loss{i}" for i in range(samebits.STEPS)]
                 + [f"{t}{f}" for t in ("", "m_", "v_")
                    for f in ("means", "log_scales", "sh")])):
            for f in fields:
                x = res["tensors"][f"{label}/d{depth}/{name}/{f}"]
                assert x.device.type == "cpu"
                assert bool(torch.isfinite(x).all()), (name, f)
            assert not any(res["launches"][f"{label}/d{depth}/{name}"]
                           .values())
        grad = res["tensors"][f"{label}/d{depth}/render/grad_scales"]
        assert float(grad.abs().max()) > 0
    assert res["card"] == "cpu"


def test_a_file_run_on_a_root_repeats_the_dump_bitwise(dumped, tmp_path):
    a, _ = dumped
    b = tmp_path / "b.pt"
    subprocess.run([sys.executable, str(SCRIPT), "--root", str(ROOT),
                    "--dump", str(b), "--device", "cpu", "--small",
                    "--iters", "1"], check=True, cwd=tmp_path, timeout=300)
    assert samebits.compare([a, b]) == []
    assert samebits.main(["--compare", str(a), str(b)]) == 0


def test_compare_names_a_changed_bit_and_a_changed_launch(dumped,
                                                          tmp_path):
    a, _ = dumped
    res = torch.load(a, weights_only=True)
    label = samebits.SMALL[0][0]
    key = f"{label}/d16/fused/rad"
    x = res["tensors"][key]
    x.view(-1)[0] = torch.nextafter(x.view(-1)[0], torch.tensor(2.0))
    res["launches"][f"{label}/d64/keys"]["peel_keys_cuda"] += 1
    b = tmp_path / "b.pt"
    torch.save(res, b)
    bad = samebits.compare([a, b])
    assert bad[0] == f"{b}: {key}"
    assert len(bad) == 2 and "launches" in bad[1]
    assert samebits.main(["--compare", str(a), str(b)]) == 1


def test_a_root_other_than_the_imported_package_is_refused(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit, match="already imported"):
        samebits.main(["--root", str(tmp_path), "--dump",
                       str(tmp_path / "x.pt"), "--device", "cpu", "--small"])
