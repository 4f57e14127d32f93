"""Port parity for GQA flash attention: the port's "torch" engine and the
plain versions of K11 and K12 against the JAX package's "jnp", "pallas" and
"pallas_kvchunk" (interpret mode) engines on the same numpy inputs, the
model's dense attention, the ragged windowed case, the (B, H, S, dh)
layout, the kv tile, the CPU wrappers and the op's refusals; and a CPU
rehearsal of the bf16 kernels' rounding (split p) against the reference's
kernels within the card tests' bf16 limit."""

import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.models.attention import _dense_gqa as j_dense_gqa  # noqa: E402
from repro.models.attention import _mask_ok as j_mask_ok  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as KF  # noqa: E402
from repro_torch.models import attention as pa  # noqa: E402

# tests/test_kernels_flash.py's sweep: (BKV, rep, S, dh, causal, window)
CFGS = [(2, 2, 64, 16, True, 0), (1, 4, 128, 32, True, 16), (3, 1, 64, 8, False, 0),
        (2, 3, 96, 16, True, 32)]
# its tolerances: fp32 2e-5; bf16 3e-2 (outputs rounded to bf16 after fp32
# sums taken in another order)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(cfg, dtype, seed=0):
    """q, k, v as numpy fp32 (rounded through bf16 for "bfloat16"), and the
    JAX arrays of that dtype."""
    BKV, rep, S, dh = cfg[:4]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(n, S, dh)).astype(np.float32) for n in (BKV * rep, BKV, BKV)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = [jnp.asarray(a, jdt) for a in arrs]
    return [np.array(x, np.float32) for x in jx], jx


def _port(xs, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [torch.from_numpy(x).to(tdt) for x in xs]


@functools.lru_cache(maxsize=None)
def _reference(cfg, dtype):
    """The JAX package's three engines on a case (kernels at q_block 32 and
    kv_block 32, as its own test runs them)."""
    rep, causal, window = cfg[1], cfg[4], cfg[5]
    _, (q, k, v) = _inputs(cfg, dtype)
    kw = dict(rep=rep, causal=causal, window=window)
    return {e: np.asarray(j_flash(q, k, v, engine=e, **kw, **extra), np.float32)
            for e, extra in (("jnp", {}), ("pallas", dict(q_block=32)),
                             ("pallas_kvchunk", dict(q_block=32, kv_block=32)))}


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("cfg", CFGS, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_engine_matches_reference(cfg, dtype):
    rep, causal, window = cfg[1], cfg[4], cfg[5]
    xs, _ = _inputs(cfg, dtype)
    q, k, v = _port(xs, dtype)
    o = flash_attention(q, k, v, rep=rep, causal=causal, window=window, engine="torch")
    assert o.dtype == q.dtype and o.shape == q.shape
    for engine, want in _reference(cfg, dtype).items():
        np.testing.assert_allclose(_f32(o), want, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=engine)


@pytest.mark.parametrize("cfg", CFGS, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_plain_versions_match_reference(cfg, dtype):
    """K11's plain version against flash_pallas, K12's (kv tile 32, the
    reference kernel's kvb) against flash_pallas_kvchunk."""
    rep, causal, window = cfg[1], cfg[4], cfg[5]
    q, k, v = _port(_inputs(cfg, dtype)[0], dtype)
    kw = dict(rep=rep, causal=causal, window=window)
    ref = _reference(cfg, dtype)
    o11 = KF.flash_plain(q, k, v, **kw)
    o12 = KF.flash_kvchunk_plain(q, k, v, kv_block=32, **kw)
    np.testing.assert_allclose(_f32(o11), ref["pallas"], rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(_f32(o12), ref["pallas_kvchunk"], rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_flash_matches_model_attention(rng):
    """tests/test_kernels_flash.py::test_flash_matches_model_attention on the
    port: the grouped-layout op against the reference model's dense GQA, and
    the port's own dense GQA against it."""
    B, KV, rep, S, dh = 1, 2, 2, 64, 16
    q5 = rng.normal(size=(B, S, KV, rep, dh)).astype(np.float32)
    k4 = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    v4 = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    ok = j_mask_ok(S, S, causal=True, window=0)
    o_model = np.asarray(j_dense_gqa(jnp.asarray(q5), jnp.asarray(k4), jnp.asarray(v4), ok))
    qg = np.ascontiguousarray(q5.transpose(0, 2, 3, 1, 4)).reshape(B * KV * rep, S, dh)
    kg = np.ascontiguousarray(k4.transpose(0, 2, 1, 3)).reshape(B * KV, S, dh)
    vg = np.ascontiguousarray(v4.transpose(0, 2, 1, 3)).reshape(B * KV, S, dh)
    for fn in (lambda *a, **kw: flash_attention(*a, engine="torch", **kw), KF.flash_plain,
               lambda *a, **kw: KF.flash_kvchunk_plain(*a, kv_block=16, **kw)):
        o = fn(torch.from_numpy(qg), torch.from_numpy(kg), torch.from_numpy(vg), rep=rep)
        o = o.numpy().reshape(B, KV, rep, S, dh).transpose(0, 3, 1, 2, 4)
        np.testing.assert_allclose(o, o_model, rtol=2e-5, atol=2e-5)
    o_port = pa._dense_gqa(torch.from_numpy(q5), torch.from_numpy(k4), torch.from_numpy(v4),
                           pa._mask_ok(S, S, causal=True, window=0))
    np.testing.assert_allclose(o_port.numpy(), o_model, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S", [100, 96])
@pytest.mark.parametrize("window", [0, 16])
def test_ragged_and_window_smaller_than_a_kv_block(S, window):
    """S not a multiple of any power-of-two tile, and a window smaller than
    the kv block: the reference's kvchunk kernel at kv_block 32 runs kv
    blocks of 25 (S 100) or 32 (S 96), each row's first blocks wholly masked
    for a window of 16."""
    cfg = (2, 3, S, 64, True, window)
    rep = cfg[1]
    xs, (jq, jk, jv) = _inputs(cfg, "float32", seed=1)
    q, k, v = _port(xs, "float32")
    want = np.asarray(j_flash(jq, jk, jv, rep=rep, window=window, engine="pallas_kvchunk",
                              q_block=32, kv_block=32))
    want_jnp = np.asarray(j_flash(jq, jk, jv, rep=rep, window=window, engine="jnp"))
    assert KF.kv_tile(32, S) == (25 if S == 100 else 32)
    o12 = KF.flash_kvchunk_plain(q, k, v, rep=rep, window=window, kv_block=32)
    np.testing.assert_allclose(o12.numpy(), want, rtol=2e-5, atol=2e-5)
    for o in (KF.flash_plain(q, k, v, rep=rep, window=window),
              flash_attention(q, k, v, rep=rep, window=window, engine="torch")):
        np.testing.assert_allclose(o.numpy(), want_jnp, rtol=2e-5, atol=2e-5)
    assert np.isfinite(o12.numpy()).all()


def test_four_d_layout_equals_grouped_layout(rng):
    """(B, H, S, dh) views of (B, S, H, dh) projections, as the model passes
    them, give the grouped layout's result in q's shape."""
    B, KV, rep, S, dh = 2, 2, 3, 40, 16
    q = torch.from_numpy(rng.normal(size=(B, S, KV * rep, dh)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KV, dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, dh)).astype(np.float32))
    q4, k4, v4 = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    grouped = [t.reshape(-1, S, dh) for t in (q4, k4, v4)]
    for fn in (KF.flash_plain, KF.flash_kvchunk_plain, KF.flash_cuda, KF.flash_kvchunk_cuda):
        o4 = fn(q4, k4, v4, rep=rep, window=7)
        o3 = fn(*grouped, rep=rep, window=7)
        assert o4.shape == (B, KV * rep, S, dh)
        assert torch.equal(o4.reshape(-1, S, dh), o3)


@pytest.mark.parametrize("kv_block,S,want", [(1024, 8192, 64), (512, 8192, 64), (32, 100, 25),
                                             (64, 96, 48), (16, 2048, 16), (1024, 97, 1),
                                             (1024, 12, 12)])
def test_kv_tile(kv_block, S, want):
    """The largest divisor of S up to min(kv_block, 64)."""
    assert KF.kv_tile(kv_block, S) == want


def test_wrappers_take_the_plain_versions_on_cpu(rng):
    q = torch.from_numpy(rng.normal(size=(6, 48, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 48, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 48, 16)).astype(np.float32))
    assert torch.equal(KF.flash_cuda(q, k, v, rep=3), KF.flash_plain(q, k, v, rep=3))
    assert torch.equal(KF.flash_kvchunk_cuda(q, k, v, rep=3, kv_block=16),
                       KF.flash_kvchunk_plain(q, k, v, rep=3, kv_block=16))
    assert torch.equal(flash_attention(q, k, v, rep=3), flash_attention(q, k, v, rep=3,
                                                                         engine="torch"))
    assert KF.FLASH.launches == 0 and KF.FLASH_KVCHUNK.launches == 0


def test_refusals(rng):
    q = torch.zeros((6, 16, 8))
    k = torch.zeros((2, 16, 8))
    for engine in ("cuda", "cuda_kvchunk"):
        with pytest.raises(ValueError, match="CUDA device"):
            flash_attention(q, k, k, rep=3, engine=engine)
    with pytest.raises(ValueError, match="unknown engine"):
        flash_attention(q, k, k, rep=3, engine="pallas")
    with pytest.raises(ValueError, match="does not match"):
        KF.flash_plain(q, k, k, rep=2)
    with pytest.raises(ValueError, match="expected"):
        KF.flash_plain(q, k[None], k[None], rep=3)
    x = torch.zeros((1, 16, 4 * 8))
    p = {n: torch.zeros((32, 32)) for n in ("wq", "wk", "wv", "wo")}
    with pytest.raises(ValueError, match="CUDA device"):
        pa.attention(p, x, None, None, n_heads=4, n_kv_heads=4, head_dim=8, engine="cuda")
    with pytest.raises(ValueError, match="unknown attention engine"):
        pa.attention(p, x, None, None, n_heads=4, n_kv_heads=4, head_dim=8, engine="jnp")


# -- the bf16 kernels' rounding, rehearsed on the CPU --------------------------------

# the card tests' bf16 limit (tests/test_torch_cuda.py::_check_flash): one
# bf16 ulp of the larger output, plus FLASH_ATOL_REL x max|want|
FLASH_ATOL_REL = 2e-5


def _over_bf16_limit(got, want):
    """How many elements of bf16 got lie outside the card's bf16 limit of
    want (both as fp32 numpy arrays)."""
    g, w = torch.from_numpy(got), torch.from_numpy(want)
    lim = FLASH_ATOL_REL * w.abs().max() + torch.ldexp(
        torch.ones_like(w), torch.frexp(torch.maximum(g.abs(), w.abs())).exponent - 8)
    return int(((g - w).abs() > lim).sum())


def _tensor_core_rounding(q, k, v, *, rep, causal, window, kvb=None, split=True):
    """The bf16 kernels' arithmetic in torch on the CPU: bf16 q, k and v;
    fp32 scores; p in fp32, split into bf16 hi = bf16(p) and lo = bf16(p -
    hi), whose two products with v accumulate in fp32 (split=False: the
    one bf16 product of bf16 p).  kvb None: K11's exact max, no rescaling;
    else K12's online softmax over tiles of kvb keys, m from -inf.  Returns
    o in bf16 as fp32 numpy."""
    BG, S, dh = q.shape
    qf = q.to(torch.float32)
    kk = torch.repeat_interleave(k, rep, dim=0).to(torch.float32)
    vv = torch.repeat_interleave(v, rep, dim=0).to(torch.float32)
    qi = torch.arange(S)[:, None]

    def scores(k0, k1):
        s = torch.einsum("bqd,bkd->bqk", qf, kk[:, k0:k1]) * (1.0 / math.sqrt(dh))
        kj = torch.arange(k0, k1)[None, :]
        ok = torch.ones((S, k1 - k0), dtype=torch.bool)
        if causal:
            ok = ok & (kj <= qi)
        if window > 0:
            ok = ok & (qi - kj < window)
        return torch.where(ok[None], s, KF.ref.NEG_INF)

    def pv(p, k0, k1):
        hi = p.to(torch.bfloat16).to(torch.float32)
        acc = torch.einsum("bqk,bkd->bqd", hi, vv[:, k0:k1])
        if split:
            lo = (p - hi).to(torch.bfloat16).to(torch.float32)
            acc = acc + torch.einsum("bqk,bkd->bqd", lo, vv[:, k0:k1])
        return acc

    if kvb is None:
        s = scores(0, S)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = pv(p, 0, S) / p.sum(-1, keepdim=True)
    else:
        acc = torch.zeros((BG, S, dh))
        m = torch.full((BG, S, 1), -math.inf)
        l = torch.zeros((BG, S, 1))
        for k0 in range(0, S, kvb):
            s = scores(k0, k0 + kvb)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + pv(p, k0, k0 + kvb)
            m = m_new
        o = acc / l
    return o.to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("cfg", CFGS, ids=str)
def test_split_p_rounding_matches_reference(cfg):
    """K11's and K12's tensor-core rounding against flash_pallas and
    flash_pallas_kvchunk (kv_block 32) in bf16, within the card's limit."""
    rep, causal, window = cfg[1], cfg[4], cfg[5]
    q, k, v = _port(_inputs(cfg, "bfloat16")[0], "bfloat16")
    ref = _reference(cfg, "bfloat16")
    kw = dict(rep=rep, causal=causal, window=window)
    assert _over_bf16_limit(_tensor_core_rounding(q, k, v, **kw), ref["pallas"]) == 0
    o12 = _tensor_core_rounding(q, k, v, kvb=KF.kv_tile(32, cfg[2]), **kw)
    assert _over_bf16_limit(o12, ref["pallas_kvchunk"]) == 0


def test_split_p_rounding_at_a_starcoder2_head_size():
    """At dh 128 over 512 keys the split p holds K11 and K12 within the
    card's limit of the reference's kernels, and one bf16 product of bf16 p
    (what SDPA does) does not: that is why the kernels split p."""
    cfg = (2, 4, 512, 128, True, 0)
    xs, (jq, jk, jv) = _inputs(cfg, "bfloat16", seed=3)
    q, k, v = _port(xs, "bfloat16")
    want11 = np.asarray(j_flash(jq, jk, jv, rep=4, engine="pallas", q_block=128), np.float32)
    want12 = np.asarray(j_flash(jq, jk, jv, rep=4, engine="pallas_kvchunk", q_block=128,
                                kv_block=64), np.float32)
    kvb = KF.kv_tile(64, 512)
    assert kvb == 64
    assert _over_bf16_limit(_tensor_core_rounding(q, k, v, rep=4, causal=True, window=0),
                            want11) == 0
    assert _over_bf16_limit(_tensor_core_rounding(q, k, v, rep=4, causal=True, window=0,
                                                  kvb=kvb), want12) == 0
    for kv in (None, kvb):
        one_pass = _tensor_core_rounding(q, k, v, rep=4, causal=True, window=0, kvb=kv,
                                         split=False)
        assert _over_bf16_limit(one_pass, want11 if kv is None else want12) > 1000


def test_check_rows_aligned():
    """The bf16 kernels copy rows in 16-byte chunks: rows that do not start
    on 16 bytes are refused before any launch."""
    x = torch.zeros((3, 16, 16), dtype=torch.bfloat16)
    KF._check_rows_aligned("flash_attention", "q", x)
    KF._check_rows_aligned("flash_attention", "q", x.permute(1, 0, 2))   # (B, H, S, dh) view
    KF._check_rows_aligned("flash_attention", "q", x[:1, :, :4])          # extent 1 strides
    with pytest.raises(ValueError, match="16 bytes"):
        KF._check_rows_aligned("flash_attention", "q", x[..., 1:9])
    with pytest.raises(ValueError, match="16 bytes"):
        KF._check_rows_aligned("flash_attention", "q", torch.zeros((3, 16, 4), dtype=torch.bfloat16))
