"""The probe kernels (rtgs_tpu_torch/ops/csrc/probe_micro.cu,
probe_ablate.cu, probe_floor.cu) against their plain torch versions, on the
card. Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_probes_cuda.py

Tolerances. Selections (argmin, merges, the chunk body's slots and t1), the
IEEE elementwise variants (copy, mult, chains, div, sqrt) and the min
reductions are bitwise. exp, exp2 and log are the CUDA math library's in
both the kernel and torch, but need not compile to the same code: 2 ulp.
Row sums (matvec_ones, touch) run in another order: 1e-5 relative.
``prod`` is the production kernel: bitwise ``peel_fused_cuda``.
kprobe's shade variants return ``intersect``'s result while their state
starts at −inf; with +inf for the state and for a missed candidate they
return the minimum of their shading terms, held against the plain minimum:
both run the same IEEE operations in the same order, and only logf against
torch.log may differ (2 ulp), which the last sum rounds into at most an ulp
of the result: rtol 1e-6, atol 1e-6."""

import math

import pytest
import torch

from rtgs_tpu_torch.ops.peel import _counts, peel_fused_cuda
from rtgs_tpu_torch.probes import _common, kmicro, kprobe, lpprobe

ULP2 = ("exp", "exp2", "exp_where")
SUMS = ("matvec_ones",)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def assert_ulp(got, ref, ulps):
    g = got.view(torch.int32).long()
    r = ref.view(torch.int32).long()
    assert int((g - r).abs().max()) <= ulps


def assert_same(got, ref):
    assert torch.equal(torch.nan_to_num(got, nan=-7.0),
                       torch.nan_to_num(ref, nan=-7.0))
    assert torch.equal(torch.isnan(got), torch.isnan(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("name", kmicro.VARIANTS)
def test_kmicro_kernel_matches_plain(cuda, name):
    x = kmicro.make_input(24, 256, 128, cuda)
    if name == "chunkbody":
        # Signed features and directions, so that rays hit.
        x = (x - 1.5).contiguous()
    before = kmicro.micro_cuda.launches
    got = kmicro.micro(name, x)
    torch.cuda.synchronize()
    assert kmicro.micro_cuda.launches == before + 1
    ref = kmicro.micro_torch(name, x)
    if name in ULP2:
        assert_ulp(got, ref, 2)
    elif name in SUMS:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
    elif name == "chunkbody":
        k = kmicro.K
        assert float(torch.isfinite(ref[..., :k]).float().mean()) > 0.05
        assert_same(got[..., :2 * k], ref[..., :2 * k])      # t1, ord
        qa_g, qa_r = got[..., 2 * k:3 * k], ref[..., 2 * k:3 * k]
        fin = torch.isfinite(qa_r)
        assert torch.equal(fin, torch.isfinite(qa_g))
        assert torch.equal(torch.isnan(qa_r), torch.isnan(qa_g))
        torch.testing.assert_close(qa_g[fin], qa_r[fin], rtol=1e-6,
                                   atol=1e-6)
        assert_same(got[..., 3 * k:], ref[..., 3 * k:])
    else:
        assert_same(got, ref)


@pytest.mark.cuda
def test_kmicro_refuses_bad_input(cuda):
    x = kmicro.make_input(2, 64, 128, cuda)
    with pytest.raises(ValueError):
        kmicro.micro("chunkbody", x)            # P < 192
    with pytest.raises(ValueError):
        kmicro.micro("nope", x)
    with pytest.raises(ValueError):
        kmicro.micro_cuda("copy", x.cpu())
    with pytest.raises(ValueError):
        kmicro.micro_cuda("copy", x.transpose(1, 2))


def _tables(dev):
    return _common.scene_tables(20_000, 160, 96, 1024, 128, 3, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", kprobe.VARIANTS)
def test_kprobe_kernel_matches_plain(cuda, name):
    packed, cand, _lb, pix, _ = _tables(cuda)
    counts = _counts(cand)
    got = kprobe.ablate(name, packed, cand, counts, pix, 16)
    torch.cuda.synchronize()
    if name in ("prod", "prod_static"):
        rad, trans, _ = peel_fused_cuda(packed, cand, counts, pix, 16)
        assert torch.equal(got, torch.cat([rad, trans[:, None]], dim=1))
        return
    ref = kprobe.ablate_torch(name, packed, cand, counts, pix, 16)
    assert float(torch.isfinite(ref[:, 0]).float().mean()) > 0.2
    assert_same(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", kprobe.SHADE_VARIANTS)
def test_kprobe_shading_matches_plain(cuda, name):
    packed, cand, _lb, pix, _ = _tables(cuda)
    counts = _counts(cand)
    got = kprobe.ablate(name, packed, cand, counts, pix, 16, math.inf,
                        math.inf)
    ref = kprobe.ablate_torch(name, packed, cand, counts, pix, 16, math.inf,
                              math.inf)
    torch.cuda.synchronize()
    assert_same(got[:, [0, 2, 3]], ref[:, [0, 2, 3]])
    fin = torch.isfinite(ref[:, 1])
    assert float(fin.float().mean()) > 0.2
    assert torch.equal(fin, torch.isfinite(got[:, 1]))
    assert not bool(torch.isnan(got[:, 1]).any())
    torch.testing.assert_close(got[:, 1][fin], ref[:, 1][fin], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
def test_lpprobe_forms_and_floors(cuda):
    packed, cand, lb, pix, _ = _tables(cuda)
    outs = {tag: fn() for tag, fn in
            lpprobe.keys_forms(packed, cand, lb, pix, 16).items()}
    assert all(lpprobe.forms_agree(outs).values())
    p = pix.shape[1]
    got = lpprobe.floor("nothing", packed, cand, p, 16)
    assert torch.equal(got, lpprobe.floor_torch("nothing", packed, cand, p,
                                                16))
    got = lpprobe.floor("touch", packed, cand, p, 16)
    ref = lpprobe.floor_torch("touch", packed, cand, p, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
    assert float(ref.abs().min()) > 0
