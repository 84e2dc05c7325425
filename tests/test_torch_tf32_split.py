"""The 3xTF32 split of the tensor-core kernels, emulated on the CPU, and the
bound that ``chip_smoke.py`` prices it at.

``fa_fwd.cu``, ``fa_bwd_dq.cu``, ``fa_bwd_dkv.cu``, ``ssd_fwd.cu`` and
``ssd_bwd.cu`` run every product on the tensor cores as TF32: an f32
operand x becomes big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big),
and a·b is taken as big·small + small·big + big·big with f32 sums.  Here
cvt.rna is emulated by integer arithmetic on the f32 bits, and a product
of two TF32 values is exact in f32, as on the tensor core.  Attention out,
lse, dq, dk and dv computed so must meet ``chip_smoke.py``'s float32
tolerances against a float64 evaluation; single-pass TF32 (big·big alone)
must miss them.  The SSD forward's and backward's chunk algebra, computed
so, must meet ``chip_smoke.SSD_TOL`` the same way, and single-pass TF32
misses it too.  That pair of facts is why those tolerances hold for the
kernels unchanged: the route keeps float32 accuracy, the tolerance was not
widened to fit it.
(The tensor core's own accumulation does not round to nearest; the
kernels keep its runs short, and this emulation sums in f32 with
rounding.)
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite float32 values: the magnitude rounded to
    10 mantissa bits, to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm_tf32(a, b):
    """Single-pass TF32: each operand rounded once; exact products, f32
    sums."""
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    """Error-compensated 3xTF32: big·small + small·big + big·big, f32 sums
    (the dropped small·small is ~2^-22 of each product)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return ab @ bs + as_ @ bb + ab @ bb


def attention(q, k, v, do, lse_in, delta, mm):
    """Causal attention out and lse, and dq, dk, dv from the given lse and
    delta, with every product through ``mm`` (the kernels' algebra: z =
    scale q kᵀ, p = exp(z - lse), dS = p (dO vᵀ - delta), dq = scale dS k,
    dk = scale dSᵀ q, dv = pᵀ dO)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    S = q.shape[-2]
    mask = tref.visible(S, S, causal=True, window=None, device="cpu")
    z = (mm(q, k.transpose(-1, -2)) * scale).masked_fill(~mask, -math.inf)
    m = z.amax(dim=-1, keepdim=True)
    p = torch.exp(z - m)
    l = p.sum(dim=-1, keepdim=True)
    out = mm(p, v) / l
    lse = m[..., 0] + torch.log(l[..., 0])
    p = torch.exp(z - lse_in[..., None])
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, k) * scale
    dv = mm(p.transpose(-1, -2), do)
    dk = mm(ds.transpose(-1, -2), q) * scale
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _misses(name, got, want):
    """Elements outside chip_smoke.py's float32 tolerance for ``name``."""
    atol, rtol = CS.TOL[("float32", "fwd" if name in ("out", "lse")
                         else "bwd")]
    err = (got.double() - want).abs()
    return int((err > atol + rtol * want.abs()).sum())


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_3xtf32_meets_float32_tolerance_and_single_pass_misses(hd):
    B, H, S = 1, 4, 512
    rng = np.random.default_rng(hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, hd))
                                    .astype(np.float32)) for _ in range(4))
    want = attention(*(t.double() for t in (q, k, v, do)),
                     torch.zeros(B, H, S, dtype=torch.float64),
                     torch.zeros(B, H, S, dtype=torch.float64),
                     lambda a, b: a @ b)
    lse64 = want["lse"]
    delta64 = (do.double() * want["out"]).sum(-1)
    want = attention(*(t.double() for t in (q, k, v, do)), lse64, delta64,
                     lambda a, b: a @ b)
    lse, delta = lse64.float(), delta64.float()
    three = attention(q, k, v, do, lse, delta, mm_3xtf32)
    one = attention(q, k, v, do, lse, delta, mm_tf32)
    for name in ("out", "lse", "dq", "dk", "dv"):
        assert _misses(name, three[name], want[name]) == 0, name
    assert any(_misses(n, one[n], want[n]) for n in one), \
        "single-pass TF32 met the float32 tolerance"
    assert _misses("dq", one["dq"], want["dq"]), \
        "single-pass TF32 met the float32 tolerance on dq"


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10                      # TF32's spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, -0.0])
    got = tf32(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)


def test_split_recovers_float32_to_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000)
                         .astype(np.float32) * 100)
    big, small = split(x)
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    assert float(((big.double() - x.double()).abs() / x.double().abs())
                 .max()) <= 2.0 ** -11


@pytest.mark.parametrize("name,bound_ms,simt_ms", [
    ("fa_fwd", 0.0586, 0.1444),
    ("fa_bwd_dq", 0.0879, 0.2166),
    ("fa_bwd_dkv", 0.1173, 0.2887),
])
def test_bounds_price_products_as_3xtf32(name, bound_ms, simt_ms):
    """At the server half's shape (B=8, S=1024, 9:3 heads, hd 64, causal:
    37,785,600 visible pairs) the three kernels stay bound by operations."""
    shape, opts = next((s, o) for c, s, o, _ in CS.CASES if c == "main-srv")
    got_ms, by, got_simt = CS._bounds(torch, shape, opts,
                                      torch.float32)[name]
    assert by == "operations"
    assert got_ms == pytest.approx(bound_ms, rel=0.01)
    assert got_simt == pytest.approx(simt_ms, rel=0.01)


def ssd_chunk_bwd(x, dt, A, Bm, Cm, h_prev, dh, dy, mm):
    """One chunk of the SSD reverse scan (``ref.ssd_bwd``'s loop body, the
    algebra of ``ssd_bwd.cu``) with every product through ``mm``: head-major
    x, dy (H, Q, P), dt (H, Q), A (H,), Bm, Cm (H, Q, N), the chunk's entry
    state h_prev and the dh carried in from the later chunks (H, N, P).
    Returns dx, ddt, dA, dB, dC in the kernels' (1, Q, H, ...) layout."""
    Q = dt.shape[-1]
    L = torch.cumsum(dt * A[:, None], dim=-1)
    Ltot = L[:, -1]
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    decay = torch.exp((L[:, :, None] - L[:, None, :]).masked_fill(
        ~tri, float("-inf")))
    scores = mm(Cm, Bm.transpose(-1, -2))
    xb = x * dt[..., None]
    expL, w = torch.exp(L), torch.exp(Ltot[:, None] - L)
    dM = mm(dy, xb.transpose(-1, -2))
    dxb = mm((scores * decay).transpose(-1, -2), dy)
    ds = dM * decay
    dC = mm(ds, Bm)
    dB = mm(ds.transpose(-1, -2), Cm)
    dd = ds * scores
    dL = dd.sum(-1) - dd.sum(-2)
    dyh = mm(dy, h_prev.transpose(-1, -2))
    dC = dC + dyh * expL[..., None]
    dL = dL + (dyh * Cm).sum(-1) * expL
    dxb = dxb + mm(Bm * w[..., None], dh)
    dBw = mm(xb, dh.transpose(-1, -2))
    dB = dB + dBw * w[..., None]
    dw = (dBw * Bm).sum(-1)
    dLtot = torch.exp(Ltot) * (dh * h_prev).sum((-1, -2)) + (dw * w).sum(-1)
    dL = dL - dw * w
    dla = torch.flip(torch.cumsum(torch.flip(dL, [-1]), -1), [-1]) \
        + dLtot[:, None]
    ddt = dla * A[:, None] + (dxb * x).sum(-1)
    lay = lambda t: t.transpose(0, 1).unsqueeze(0)
    return {"dx": lay(dxb * dt[..., None]), "ddt": lay(ddt),
            "dA": (dla * dt).sum(-1), "dB": lay(dB), "dC": lay(dC)}


def ssd_chunk_fwd(x, dt, A, Bm, Cm, h_prev, mm):
    """One chunk of the SSD scan (``ref.ssd_scan``'s loop body, the algebra
    of ``ssd_fwd.cu``) with every product through ``mm``: head-major x
    (H, Q, P), dt (H, Q), A (H,), Bm, Cm (H, Q, N) and the chunk's entry
    state h_prev (H, N, P).  Returns y in the kernel's (1, Q, H, P) layout
    and the next chunk's entry state h_new as "states" (1, H, N, P)."""
    Q = dt.shape[-1]
    L = torch.cumsum(dt * A[:, None], dim=-1)
    Ltot = L[:, -1]
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    decay = torch.exp((L[:, :, None] - L[:, None, :]).masked_fill(
        ~tri, float("-inf")))
    xb = x * dt[..., None]
    y = mm(mm(Cm, Bm.transpose(-1, -2)) * decay, xb) \
        + mm(Cm, h_prev) * torch.exp(L)[..., None]
    w = torch.exp(Ltot[:, None] - L)
    h_new = torch.exp(Ltot)[:, None, None] * h_prev \
        + mm(Bm.transpose(-1, -2), xb * w[..., None])
    return {"y": y.transpose(0, 1).unsqueeze(0), "states": h_new.unsqueeze(0)}


def _ssd_chunk_inputs(H=4, Q=256, N=128, P=64, seed=0):
    """mamba2-780m's widths (chunk 256, N 128, P 64) at a few heads: A from
    -1 down to -48, dt log-normal around 0.1, B, C ~ N(0, 1/4), x, dy, and
    an entry state and incoming dh of the size a full-width chunk sees."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, dy = f(H, Q, P), f(H, Q, P)
    dt = 0.1 * torch.exp(0.5 * f(H, Q))
    A = -torch.linspace(1.0, 48.0, H)
    Bm, Cm = 0.5 * f(1, Q, N).expand(H, Q, N), 0.5 * f(1, Q, N).expand(H, Q, N)
    h_prev, dh = 3.0 * f(H, N, P), 3.0 * f(H, N, P)
    return x, dt, A, Bm.contiguous(), Cm.contiguous(), h_prev, dh, dy


def _ssd_misses(got, want, x, dt, A):
    """Elements outside ``chip_smoke.SSD_TOL`` (scaled per head by
    ``ref.ssd_scales``) of each output against the float64 evaluation."""
    lay = lambda t: t.transpose(0, 1).unsqueeze(0)
    scale = tref.ssd_scales(lay(x.double()), lay(dt.double()), A.double(),
                            want)
    atol, rtol = CS.SSD_TOL
    return {n: int(((got[n].double() - want[n]).abs()
                    > atol * scale[n] + rtol * want[n].abs()).sum())
            for n in want}


def test_ssd_bwd_3xtf32_meets_ssd_tolerance():
    """The SSD backward at float32 with its products as 3xTF32 (the route of
    ssd_bwd.cu) meets SSD_TOL against float64 on every output."""
    ins = _ssd_chunk_inputs()
    want = ssd_chunk_bwd(*(t.double() for t in ins), lambda a, b: a @ b)
    three = ssd_chunk_bwd(*ins, mm_3xtf32)
    assert all(torch.isfinite(t).all() for t in three.values())
    assert _ssd_misses(three, want, *ins[:3]) == dict.fromkeys(want, 0)


def test_ssd_bwd_single_pass_tf32_misses():
    """Single-pass TF32 products do not keep the SSD backward at float32
    accuracy: ddt (which cancels two terms up to |A| = 48 times its size)
    misses SSD_TOL."""
    ins = _ssd_chunk_inputs()
    want = ssd_chunk_bwd(*(t.double() for t in ins), lambda a, b: a @ b)
    one = ssd_chunk_bwd(*ins, mm_tf32)
    assert _ssd_misses(one, want, *ins[:3])["ddt"] > 0


def test_ssd_fwd_3xtf32_meets_ssd_tolerance():
    """The SSD forward at float32 with its products as 3xTF32 (the route of
    ssd_fwd.cu) meets SSD_TOL against float64 on y and the next state."""
    x, dt, A, Bm, Cm, h_prev, _, _ = _ssd_chunk_inputs()
    ins = (x, dt, A, Bm, Cm, h_prev)
    want = ssd_chunk_fwd(*(t.double() for t in ins), lambda a, b: a @ b)
    three = ssd_chunk_fwd(*ins, mm_3xtf32)
    assert all(torch.isfinite(t).all() for t in three.values())
    assert _ssd_misses(three, want, x, dt, A) == dict.fromkeys(want, 0)


def test_ssd_fwd_single_pass_tf32_misses():
    """Single-pass TF32 products do not keep the SSD forward at float32
    accuracy: y misses SSD_TOL."""
    x, dt, A, Bm, Cm, h_prev, _, _ = _ssd_chunk_inputs()
    ins = (x, dt, A, Bm, Cm, h_prev)
    want = ssd_chunk_fwd(*(t.double() for t in ins), lambda a, b: a @ b)
    one = ssd_chunk_fwd(*ins, mm_tf32)
    assert _ssd_misses(one, want, x, dt, A)["y"] > 0


@pytest.mark.parametrize("name,bound_ms,simt_ms", [
    ("ssd_fwd", 0.1189, 0.2929),
    ("ssd_bwd", 0.3930, 0.9678),
])
def test_ssd_bounds_price_products_as_3xtf32(name, bound_ms, simt_ms):
    """At the server half's SSD shape (B=8, T=1024, 48 heads, P 64, G 1,
    N 128, chunk 256) both SSD kernels stay bound by operations."""
    shape = next(s for c, s, _ in CS.SSD_CASES if c == "main-srv")
    got_ms, by, got_simt = CS._ssd_bounds(shape, shape[-1])[name]
    assert by == "operations"
    assert got_ms == pytest.approx(bound_ms, rel=0.01)
    assert got_simt == pytest.approx(simt_ms, rel=0.01)
