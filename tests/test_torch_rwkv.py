"""Port parity for the RWKV6 WKV op: the port's "torch" (chunked) and
"scan" engines against the JAX package's "jnp", "scan" and "pallas"
(interpret mode) engines on the same numpy inputs, the decode step, the
chunk choice, K10's CPU wrappers and the refusals of the "cuda" engine;
the torch emulation of K10's factored chunk (ref.chunk_body_factored)
against the reference's chunk_body."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_scan import ref as j_ref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6 as j_rwkv6  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_decode_step as j_decode  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as K10  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_decode_step  # noqa: E402

# The port's chunked form against the reference's.  The reference holds its
# own pallas and jnp engines to a flat 3e-5, but a torch chunk_body against
# the jnp engine misses that at the larger shapes: 1.9e-4 at max|o| = 31.5
# for (2,4,256,64,64) with chunk 64, the fp32 sums over C * dk terms being
# taken in another order.  The error scales with the output's size (below
# 6e-6 x max|ref| in every case), so the absolute tolerance does too.
RTOL, ATOL_REL = 1e-5, 2e-5
# the reference's own tolerance between its chunked form and the scan oracle
# (tests/test_kernels_rwkv.py), whose sums differ in order over the sequence
SCAN_TOL = 1e-3


def _problem(rng, B, H, T, dk, dv, strong_decay=True):
    """tests/test_kernels_rwkv.py's inputs."""
    r = rng.normal(size=(B, H, T, dk)).astype(np.float32)
    k = (0.3 * rng.normal(size=(B, H, T, dk))).astype(np.float32)
    v = rng.normal(size=(B, H, T, dv)).astype(np.float32)
    scale = 1.0 if strong_decay else -2.0
    w = np.exp(-np.exp(scale + rng.normal(size=(B, H, T, dk)))).astype(np.float32)
    u = (0.5 * rng.normal(size=(H, dk))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, dk, dv))).astype(np.float32)
    return r, k, v, w, u, s0


@functools.lru_cache(maxsize=None)
def _scan_case(shape):
    """The inputs of a shape (seed 0) with the reference's scan oracle on
    them, shared by the chunk sizes."""
    prob = _problem(np.random.default_rng(0), *shape)
    return prob, j_rwkv6(*prob, engine="scan")


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


@pytest.mark.parametrize("shape", [(1, 1, 32, 8, 8), (2, 3, 128, 16, 24),
                                   (1, 2, 64, 32, 32)], ids=str)
@pytest.mark.parametrize("chunk", [16, 32])
def test_engines_match_reference(shape, chunk):
    prob, (o_js, s_js) = _scan_case(shape)
    o_jnp, s_jnp = j_rwkv6(*prob, engine="jnp", chunk=chunk)
    o_pl, s_pl = j_rwkv6(*prob, engine="pallas", chunk=chunk)
    o, s = rwkv6(*_t(*prob), engine="torch", chunk=chunk)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    for want_o, want_s in ((o_jnp, s_jnp), (o_pl, s_pl)):
        _close(o, want_o)
        _close(s, want_s)
    o_sc, s_sc = rwkv6(*_t(*prob), engine="scan")
    _close(o_sc, o_js)
    _close(s_sc, s_js)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_js), rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_js), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_full_head_chunk_matches_reference(rng):
    """rwkv6-7b's head size and chunk: (2, 4, 256, 64, 64), chunk 64."""
    prob = _problem(rng, 2, 4, 256, 64, 64)
    o_jnp, s_jnp = j_rwkv6(*prob, engine="jnp", chunk=64)
    o, s = rwkv6(*_t(*prob), engine="torch", chunk=64)
    _close(o, o_jnp)
    _close(s, s_jnp)


def test_strong_decay_no_overflow(rng):
    """w near 0 (aggressive forgetting): finite, within the reference's 1e-4
    of its scan oracle."""
    r, k, v, w, u, s0 = _problem(rng, 1, 1, 64, 8, 8)
    w = np.full_like(w, 1e-6)
    o_ref, _ = j_rwkv6(r, k, v, w, u, s0, engine="scan")
    o, _ = rwkv6(*_t(r, k, v, w, u, s0), engine="torch", chunk=32)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-4, atol=1e-4)


def test_decode_continues_scan(rng):
    B, H, T, dk, dv = 2, 2, 16, 8, 8
    r, k, v, w, u, s0 = _problem(rng, B, H, T, dk, dv)
    o_ref, s_ref = j_rwkv6(r, k, v, w, u, s0, engine="scan")
    s, sj = torch.from_numpy(s0), jnp.asarray(s0)
    outs = []
    for t in range(T):
        xs = [x[:, :, t] for x in (r, k, v, w)]
        o1, s = rwkv6_decode_step(*_t(*xs), torch.from_numpy(u), s)
        oj, sj = j_decode(*xs, jnp.asarray(u), sj)
        _close(o1, oj)
        outs.append(o1.numpy())
    _close(s, sj)
    # the reference's own tolerance for decode against its scan
    np.testing.assert_allclose(np.stack(outs, 2), np.asarray(o_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T,want", [(100, 50), (97, 1), (64, 64), (24, 24)])
def test_chunk_choice(T, want, rng):
    """min(chunk, T), then down until it divides T, as the reference picks."""
    assert ops.pick_chunk(64, T) == want
    prob = _problem(rng, 1, 2, T, 16, 16)
    o, s = rwkv6(*_t(*prob), engine="torch")
    o_c, s_c = ref.rwkv6_chunked(*_t(*prob), chunk=want)
    assert torch.equal(o, o_c) and torch.equal(s, s_c)
    if T == 100:
        o_j, s_j = j_rwkv6(*prob, engine="jnp")
        _close(o, o_j)
        _close(s, s_j)


def test_auto_engine_and_dtype_on_cpu(rng):
    prob = _t(*_problem(rng, 1, 2, 32, 8, 8))
    o, s = rwkv6(*prob)
    o_t, s_t = rwkv6(*prob, engine="torch")
    assert torch.equal(o, o_t) and torch.equal(s, s_t)
    ob, _ = rwkv6(*(x.to(torch.bfloat16) for x in prob[:4]), prob[4], prob[5])
    assert ob.dtype == torch.bfloat16


def test_kernel_wrapper_takes_the_plain_version_on_cpu(rng):
    B, H, T, dk, dv = 2, 3, 48, 16, 8
    r, k, v, w, u, s0 = _t(*_problem(rng, B, H, T, dk, dv))
    BH = B * H
    ub = u.expand(B, H, dk).reshape(BH, dk)
    o, s = K10.rwkv6_cuda(r.reshape(BH, T, dk), k.reshape(BH, T, dk), v.reshape(BH, T, dv),
                          w.reshape(BH, T, dk), ub, s0.reshape(BH, dk, dv), chunk=16)
    o_c, s_c = ref.rwkv6_chunked(r, k, v, w, u, s0, chunk=16)
    assert torch.equal(o, o_c.reshape(BH, T, dv)) and torch.equal(s, s_c.reshape(BH, dk, dv))
    assert K10.WKV.launches == 0


def test_refusals(rng):
    r, k, v, w, u, s0 = _t(*_problem(rng, 1, 2, 32, 8, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        rwkv6(r, k, v, w, u, s0, engine="cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        rwkv6(r, k, v, w, u, s0, engine="pallas")
    # the limits are checked before any device check
    r2, k2, v2, w2, u2, s02 = _t(*_problem(rng, 1, 2, 128, 8, 8))
    with pytest.raises(ValueError, match="chunk from 1 to 64, got 128"):
        rwkv6(r2, k2, v2, w2, u2, s02, engine="cuda", chunk=128)
    r3, k3, v3, w3, u3, s03 = _t(*_problem(rng, 1, 1, 16, 80, 8))
    with pytest.raises(ValueError, match="dk from 1 to 64, got 80"):
        rwkv6(r3, k3, v3, w3, u3, s03, engine="cuda")
    r4, k4, v4, w4, u4, s04 = _t(*_problem(rng, 1, 1, 16, 8, 96))
    with pytest.raises(ValueError, match="dv from 1 to 64, got 96"):
        rwkv6(r4, k4, v4, w4, u4, s04, engine="cuda")
    with pytest.raises(ValueError, match="dv from 1 to 64, got 96"):
        K10.rwkv6_cuda(r4[0], k4[0], v4[0], w4[0], u4, s04[0], chunk=16)
    with pytest.raises(ValueError, match="must divide"):
        K10.rwkv6_cuda(r[0], k[0], v[0], w[0], u, s0[0], chunk=24)


# K10's factored chunk against the reference's chunk_body, one chunk a head:
# rwkv6-7b's C = dk = dv = 64, odd sizes (a partial sub-chunk, dk and dv
# under a tile), and decays from the strong inputs of _problem, at the
# kernel's clamp (1e-26: the log is -59.9 a step, so a factor taken about
# a sub-chunk's start would reach e^958) and w = 1 exactly (L = 0).
# At the clamp |L| reaches 3.8e3 in a chunk, where fp32's spacing is
# 2.4e-4, and the reference's own chunk_body loses the pairs s = t - 1 to
# the cancellation in Lprev_t - L_s = (L_t - log w_t) - L_{t-1}: it lies
# 2.3e-3 from the same closed form in fp64 at C = 64 (max|o| 20.9), beyond
# the tolerance, and the port's plain chunk_body 3.7e-3.  There the
# factored chunk (Lprev_t = L_{t-1}, no cancellation) is held to the fp64
# closed form within the tolerance, and to the reference within the
# reference's own distance from it plus the tolerance.
FACTORED_SHAPES = [(64, 64, 64), (7, 5, 3), (50, 16, 16)]


@pytest.mark.parametrize("decay", ["strong", "clamp", "one"])
@pytest.mark.parametrize("C,dk,dv", FACTORED_SHAPES, ids=str)
def test_factored_chunk_matches_reference_chunk_body(C, dk, dv, decay, rng):
    N = 3
    r, k, v, w, u, s0 = _problem(rng, 1, N, C, dk, dv)
    r, k, v, w, s0 = (x[0] for x in (r, k, v, w, s0))     # u is (N, dk) already
    w = {"strong": w, "clamp": np.full_like(w, 1e-26), "one": np.ones_like(w)}[decay]
    lw = np.log(np.maximum(w, np.float32(1e-26))).astype(np.float32)
    args = (r, k, v, lw, u, s0)
    got = ref.chunk_body_factored(*_t(*args))
    assert all(torch.isfinite(x).all() for x in got)
    want = jax.vmap(j_ref.chunk_body)(*(jnp.asarray(x) for x in args))
    if decay != "clamp":
        for g, w_ in zip(got, want):
            _close(g, w_)
        # the port's chunk_body, which the plain version runs, on the same inputs
        for g, p_ in zip(got, ref.chunk_body(*_t(*args))):
            _close(g, p_)
        return
    exact = ref.chunk_body(*(torch.from_numpy(x.astype(np.float64)) for x in args))
    for g, w_, x in zip(got, want, exact):
        g, w_, x = g.numpy(), np.asarray(w_), x.numpy()
        _close(g, x)
        tol = RTOL * np.abs(w_) + ATOL_REL * np.abs(w_).max()
        assert (np.abs(g - w_) <= np.abs(w_ - x) + tol).all()


def test_heads_wrapper_on_strided_bf16_views(rng):
    """The "cuda" engine's wrapper on the model's operands, run here through
    its plain version: bf16 (B, H, T, d) views permuted from (B, T, H, d)
    give rwkv6_chunked's o cast to bf16, bitwise, in the (B, T, H, dv) order
    the model merges its heads from; the kernels' operand handling keeps
    such views as they are and makes mixed or scattered ones uniform."""
    B, H, T, dk, dv = 2, 3, 40, 16, 8
    prob = _problem(rng, B, H, T, dk, dv)

    def view(x):   # (B, H, T, d) -> bf16 (B, T, H, d) contiguous -> permuted view
        return torch.from_numpy(x).to(torch.bfloat16).permute(0, 2, 1, 3).contiguous() \
            .permute(0, 2, 1, 3)

    r, k, v, w = (view(x) for x in prob[:4])
    u, s0 = _t(*prob[4:])
    assert not r.is_contiguous()
    before = (K10.WKV.launches, K10.WKV_STATE.launches)
    o, sT = K10.rwkv6_heads_cuda(r, k, v, w, u, s0, chunk=8)
    o_c, s_c = ref.rwkv6_chunked(r, k, v, w, u, s0, chunk=8)
    assert o.dtype == torch.bfloat16 and torch.equal(o, o_c.to(torch.bfloat16))
    assert torch.equal(sT, s_c)
    assert o.permute(0, 2, 1, 3).is_contiguous()     # _unheads takes it without a copy
    o_op, s_op = rwkv6(r, k, v, w, u, s0, engine="torch", chunk=8)
    assert torch.equal(o, o_op) and torch.equal(sT, s_op)
    o0, _ = K10.rwkv6_heads_cuda(r, k, v, w, u, chunk=8)
    assert torch.equal(o0, ref.rwkv6_chunked(r, k, v, w, u, chunk=8)[0].to(torch.bfloat16))
    assert (K10.WKV.launches, K10.WKV_STATE.launches) == before
    # the operands as the kernels read them: the model's views unchanged
    xs = K10._operands(r, k, v, w)
    assert [x.data_ptr() for x in xs] == [x.data_ptr() for x in (r, k, v, w)]
    assert all(x.dtype == torch.bfloat16 for x in xs)
    # mixed dtypes: all fp32; r, k, w at different strides: contiguous copies
    xs = K10._operands(r, k.float(), v, w)
    assert all(x.dtype == torch.float32 for x in xs)
    xs = K10._operands(r.contiguous(), k, v, w)
    assert all(x.is_contiguous() for x in xs)
    with pytest.raises(ValueError, match="shape"):
        K10.rwkv6_heads_cuda(r, k, v, w[:, :, :8], u, s0, chunk=8)
