"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card: it carries the ``cuda`` marker and skips
(inside the ``card`` fixture) when ``torch.cuda.is_available()`` is false.
The file imports no JAX, so it runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.apps.ludwig import LudwigConfig, init_state, step  # noqa: E402
from repro_torch.apps.ludwig import driver as LD  # noqa: E402
from repro_torch.apps.ludwig import kernel as LK  # noqa: E402
from repro_torch.apps.milc import MilcConfig, fields, init_problem, residual_check, solve  # noqa: E402
from repro_torch.apps.milc import cg as CG  # noqa: E402
from repro_torch.core import (SOA, DtypePolicy, Field, TargetConfig, fuse, parse_layout,  # noqa: E402
                              reduce, target)
from repro_torch.core import plan as pplan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as KF  # noqa: E402
from repro_torch.kernels.lb_collision import kernel as K7  # noqa: E402
from repro_torch.kernels.lb_propagation import kernel as K8  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as K10  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6  # noqa: E402
from repro_torch.kernels.wilson_dslash import dslash  # noqa: E402
from repro_torch.kernels.wilson_dslash import kernel as K  # noqa: E402

FIELD_RTOL = 1e-5  # max|kernel - plain| <= FIELD_RTOL * max|plain|
SUM_RTOL = 1e-5    # |kernel - plain| <= SUM_RTOL * sum|terms|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _close_field(got, want):
    assert (got - want).abs().max() <= FIELD_RTOL * want.abs().max()


def _close_sum(got, want, terms):
    assert bool(((got - want).abs() <= SUM_RTOL * terms.abs().sum(dim=-1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nsites,vvl", [(4096, 128), (480, 32), (1000, 64)])
def test_site_and_reduce_kernels(card, nsites, vvl, rng):
    x, y = (torch.from_numpy(rng.normal(size=(24, nsites)).astype(np.float32)).to(card)
            for _ in range(2))
    a = torch.tensor(0.3, device=card)
    assert torch.equal(target.site_g5(x, 12, vvl), target.g5_plain(x, 12))
    assert torch.equal(target.site_mul(x, y, vvl), x * y)
    _close_field(target.site_axpy(0.5, x, y, vvl), x * 0.5 + y)
    assert torch.equal(reduce.reduce_sites(x, "max", vvl), x.amax(dim=1))
    _close_sum(reduce.reduce_sites(x, "sum", vvl), x.sum(dim=1), x)
    # a fixed plan gives the same bits on every run (no atomics)
    assert torch.equal(reduce.reduce_sites(x, "sum", vvl), reduce.reduce_sites(x, "sum", vvl))
    x_new, r_new, rr = fuse.cg_update(x, y, y, x, a, -a, vvl)
    w = fuse.cg_update_plain(x, y, y, x, a, -a)
    _close_field(x_new, w[0])
    _close_field(r_new, w[1])
    _close_sum(rr, w[2], w[1] * w[1])
    _close_field(fuse.cg_xpay(x, y, a, vvl), y + a * x)


@pytest.mark.cuda
def test_wrappers_refuse_what_they_do_not_take(card):
    x = torch.zeros((24, 256), device=card)
    with pytest.raises(ValueError, match="float32"):
        target.site_mul(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        target.site_mul(x.T, x.T)
    with pytest.raises(ValueError, match="shape"):
        K.dslash_cuda(x, torch.zeros((72, 128), device=card), (4, 4, 4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("lat", [(4, 4, 4, 4), (2, 6, 4, 10), (1, 3, 5, 8)])
def test_wilson_kernels(card, lat, rng):
    V = int(np.prod(lat))
    psi = torch.from_numpy(rng.normal(size=(24, V)).astype(np.float32)).to(card)
    u = torch.from_numpy(fields.random_su3_gauge(lat, seed=1).reshape(72, -1)).to(card)
    _close_field(K.dslash_cuda(psi, u, lat, vvl=32), K.dslash_plain(psi, u, lat))
    ap, pap = K.wilson_normal_cuda(psi, u, 0.12, lat, vvl=32)
    ap2, pap2 = K.wilson_normal_plain(psi, u, 0.12, lat)
    _close_field(ap, ap2)
    _close_sum(pap, pap2, psi * ap2)


@pytest.mark.cuda
def test_cuda_engine_solve_matches_torch_engine(card):
    kw = dict(lattice=(4, 4, 4, 8), kappa=0.10, tol=1e-10, max_iter=2000)
    cfg = MilcConfig(target=TargetConfig("cuda", device="cuda"), **kw)
    tcfg = MilcConfig(target=TargetConfig("torch", device="cuda"), **kw)
    u, b = init_problem(cfg)
    launches = fuse.CG_UPDATE.launches
    rc, rt = solve(cfg, u, b), solve(tcfg, u, b)
    assert fuse.CG_UPDATE.launches - launches == rc.iterations
    assert abs(rc.iterations - rt.iterations) <= 1
    assert (torch.linalg.norm(rc.x.data - rt.x.data) / torch.linalg.norm(rt.x.data)) < 1e-5
    assert residual_check(cfg, u, b, rc.x) < 1e-3


LB_LATTICES = [(4, 4, 8), (3, 5, 7), (1, 6, 4), (2, 1, 3)]


def _dev(rng, shape, card, scale=1.0, offset=0.0):
    return torch.from_numpy((offset + scale * rng.normal(size=shape)).astype(np.float32)).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("vvl", [32, 64, 128])
@pytest.mark.parametrize("lat", LB_LATTICES, ids=str)
def test_lb_kernels(card, lat, vvl, rng):
    V = int(np.prod(lat))
    f = _dev(rng, (19, V), card, 0.1, 1.0)
    g = _dev(rng, (3, V), card, 0.01)
    c = K7.collide_cuda(f, g, 0.8, vvl)
    _close_field(c, K7.collide_plain(f, g, 0.8))
    # streaming moves data only: bitwise, and the same kernel on any vvl
    p = K8.propagate_cuda(c, lat, vvl)
    assert torch.equal(p, K8.propagate_plain(c, lat))
    dist2, u = K8.lb_step_cuda(f, g, 0.8, lat, vvl)
    want2, want_u = K8.lb_step_plain(f, g, 0.8, lat)
    _close_field(dist2, want2)
    _close_field(u, want_u)
    # K5L's streaming half moves K7's values: bitwise equal to K8(K7(f))
    assert torch.equal(dist2, p)
    only2, none = K8.lb_step_cuda(f, g, 0.8, lat, vvl, with_u=False)
    assert none is None and torch.equal(only2, dist2)


@pytest.mark.cuda
@pytest.mark.parametrize("vvl", [32, 64, 128])
@pytest.mark.parametrize("lat", LB_LATTICES, ids=str)
def test_ludwig_flat_kernels(card, lat, vvl, rng):
    V = int(np.prod(lat))
    q, lapq, h, adv = (_dev(rng, (5, V), card, 0.05) for _ in range(4))
    dq, w = _dev(rng, (15, V), card, 0.02), _dev(rng, (9, V), card, 0.01)
    kw = dict(a0=0.01, gamma=3.0, kappa_m=0.01, kappa_s=0.01, xi=0.7)
    got = LK.chem_stress_cuda(q, lapq, dq, vvl=vvl, **kw)
    want = LK.chem_stress_plain(q, lapq, dq, **kw)
    _close_field(got[0], want[0])
    _close_field(got[1], want[1])
    kw = dict(gamma_rot=0.3, xi=0.7, dt=1.0)
    _close_field(LK.lc_update_cuda(q, h, w, adv, vvl=vvl, **kw),
                 LK.lc_update_plain(q, h, w, adv, **kw))
    kw = dict(a0=0.01, gamma=3.0, kappa=0.01)
    _close_field(LK.fed_cuda(q, dq, vvl=vvl, **kw), LK.fed_plain(q, dq, **kw))


@pytest.mark.cuda
def test_cuda_engine_step_matches_torch_engine(card):
    cfg = LudwigConfig(lattice=(8, 8, 8), target=TargetConfig("cuda", device="cuda"))
    tcfg = LudwigConfig(lattice=(8, 8, 8), target=TargetConfig("torch", device="cuda"))
    launches = K8.LB_STEP.launches
    s, t = init_state(cfg, seed=0), init_state(tcfg, seed=0)
    for _ in range(3):
        s, t = step(s, cfg), step(t, tcfg)
    assert K8.LB_STEP.launches - launches == 3
    for a, b in ((s.q.data, t.q.data), (s.dist.data, t.dist.data)):
        assert torch.allclose(a, b, rtol=3e-5, atol=1e-7)


# K9 tiles: odd extents, extents that are no multiple of a warp, and windows
# that wrap across lattice edges (a whole axis, an extent of 1, the last tile)
K9_CASES = [((8, 8, 8), (1, 1, 2)), ((8, 8, 8), (4, 4, 8)), ((8, 8, 8), (8, 8, 8)),
            ((4, 14, 16), (2, 7, 4)), ((4, 14, 16), (1, 14, 16)), ((4, 14, 16), (4, 2, 1)),
            ((16, 16, 32), (4, 4, 8)), ((16, 16, 32), (1, 4, 32)), ((16, 16, 32), (16, 1, 2)),
            ((6, 6, 12), (2, 3, 6))]   # bz 6: no multiple of 4


@pytest.mark.cuda
@pytest.mark.parametrize("lat,tile", K9_CASES, ids=str)
def test_k9_tiled_lb_step(card, lat, tile, rng):
    """Bitwise K5L, with and without u, at the default block and at blocks
    of 64 threads, and within tolerance of the tile-by-tile plain version."""
    V = int(np.prod(lat))
    f = _dev(rng, (19, V), card, 0.1, 1.0)
    g = _dev(rng, (3, V), card, 0.01)
    launches = K8.LB_STEP_TILED.launches
    k5, k5u = K8.lb_step_cuda(f, g, 0.8, lat, 32)
    want2, want_u = K8.lb_step_tiled_plain(f, g, 0.8, lat, tile)
    for block in (K8.K9_BLOCK, 64):
        dist2, u = K8.lb_step_tiled_cuda(f, g, 0.8, lat, tile, block=block)
        # the same collision code as K5L, and streaming only moves its values
        assert torch.equal(dist2, k5) and torch.equal(u, k5u)
        only2, none = K8.lb_step_tiled_cuda(f, g, 0.8, lat, tile, with_u=False, block=block)
        assert none is None and torch.equal(only2, k5)
        _close_field(dist2, want2)
        _close_field(u, want_u)
    assert K8.LB_STEP_TILED.launches - launches == 4


@pytest.mark.cuda
def test_tiled_steps_equal_untiled_steps(card):
    """Three steps under a shared-memory budget (the LB half-step tiled, K9),
    at 227 KiB and at a budget small enough for the odd tile (1, 1, 2),
    equal three untiled steps (K5L) bitwise."""
    lat = (16, 16, 16)
    cfgs = [LudwigConfig(lattice=lat, target=TargetConfig("cuda", device="cuda", smem_bytes=b))
            for b in (None, 227 * 1024, 6512)]
    tiled, untiled = K8.LB_STEP_TILED.launches, K8.LB_STEP.launches
    states = [init_state(c, seed=0) for c in cfgs]
    for _ in range(3):
        states = [step(s, c) for s, c in zip(states, cfgs)]
    assert K8.LB_STEP_TILED.launches - tiled == 6 and K8.LB_STEP.launches - untiled == 3
    for s in states[1:]:
        assert torch.equal(s.dist.data, states[0].dist.data)
        assert torch.equal(s.q.data, states[0].q.data)


# K10 against its plain version (ref.rwkv6_chunked): the same arithmetic with
# the fp32 sums over C * dk terms in another order; the error scales with
# the output's size (tests/test_torch_rwkv.py states the same tolerance
# between the port's chunked form and the reference's).
WKV_RTOL, WKV_ATOL_REL = 1e-5, 2e-5
# (B, H, T, dk, dv, chunk): rwkv6-7b's head and chunk, C < 64 with small
# heads (T 100 runs chunks of 50), uneven dk / dv, odd sizes, chunks of 1
K10_CASES = [(1, 2, 128, 64, 64, 64), (2, 3, 100, 16, 16, 50), (1, 2, 96, 24, 32, 32),
             (2, 1, 64, 8, 8, 16), (1, 3, 21, 5, 3, 7), (1, 1, 9, 64, 64, 1),
             (1, 4, 640, 64, 64, 64)]   # T / C = 10: the state pass carries over many chunks


def _wkv_problem(rng, B, H, T, dk, dv, device):
    """tests/test_kernels_rwkv.py's inputs (strong decay) and a random u."""
    def n(shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(device)
    w = torch.exp(-torch.exp(1.0 + n((B, H, T, dk))))
    return (n((B, H, T, dk)), n((B, H, T, dk), 0.3), n((B, H, T, dv)), w, n((H, dk), 0.5),
            n((B, H, dk, dv), 0.1))


def _close_wkv(got, want):
    torch.testing.assert_close(got, want, rtol=WKV_RTOL, atol=WKV_ATOL_REL * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,dk,dv,chunk", K10_CASES, ids=str)
def test_k10_wkv(card, B, H, T, dk, dv, chunk, rng):
    r, k, v, w, u, s0 = _wkv_problem(rng, B, H, T, dk, dv, card)
    BH = B * H
    flat = [x.reshape(BH, T, -1) for x in (r, k, v, w)]
    ub = u.expand(B, H, dk).reshape(BH, dk)
    launches = (K10.WKV.launches, K10.WKV_STATE.launches)
    o, sT = K10.rwkv6_cuda(*flat, ub, s0.reshape(BH, dk, dv), chunk=chunk)
    torch.cuda.synchronize()
    assert (K10.WKV.launches - launches[0], K10.WKV_STATE.launches - launches[1]) == (1, 1)
    o_p, s_p = K10.rwkv6_plain(*flat, ub, s0.reshape(BH, dk, dv), chunk=chunk)
    _close_wkv(o, o_p)
    _close_wkv(sT, s_p)
    # the scan oracle, within the reference's chunked-vs-scan tolerance
    o_s, s_s = wkv_ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o.reshape(B, H, T, dv), o_s, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(sT.reshape(B, H, dk, dv), s_s, rtol=1e-3, atol=1e-3)


def _chunked_f64(r, k, v, w, u, s0, chunk):
    """ref.rwkv6_chunked's closed form in fp64 on (B, H, T, d) tensors:
    the accurate value of the function K10 and its plain version compute."""
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    f64 = lambda x, d: x.double().reshape(B * H, -1, d)   # noqa: E731
    r, k, v = f64(r, dk), f64(k, dk), f64(v, dv)
    lw = torch.log(torch.clamp(w.double(), min=1e-26)).reshape(B * H, T, dk)
    uh = u.double().expand(B, H, dk).reshape(B * H, dk)
    S = s0.double().reshape(B * H, dk, dv)
    outs = []
    for c in range(0, T, chunk):
        o, S = wkv_ref.chunk_body(r[:, c:c + chunk], k[:, c:c + chunk], v[:, c:c + chunk],
                                  lw[:, c:c + chunk], uh, S)
        outs.append(o)
    return torch.cat(outs, 1).reshape(B, H, T, dv), S.reshape(B, H, dk, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k10_heads_on_strided_views(card, dtype, rng):
    """The model's operands: (B, H, T, d) views permuted from (B, T, H, d),
    fp32 or bf16, read in place; o in their dtype in (B, T, H, dv) order.
    fp32 within the K10 tolerance of the plain version, bf16 within one
    bf16 ulp of it (plus the atol); sT within the tolerance."""
    B, H, T, d = 2, 4, 256, 64
    r, k, v, w, u, s0 = _wkv_problem(rng, B, H, T, d, d, card)
    views = [x.to(dtype).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
             for x in (r, k, v, w)]
    launches = (K10.WKV.launches, K10.WKV_STATE.launches)
    o, sT = K10.rwkv6_heads_cuda(*views, u, s0, chunk=64)
    torch.cuda.synchronize()
    assert (K10.WKV.launches - launches[0], K10.WKV_STATE.launches - launches[1]) == (1, 1)
    assert o.dtype == dtype and o.permute(0, 2, 1, 3).is_contiguous()
    o_p, s_p = wkv_ref.rwkv6_chunked(*views, u, s0, chunk=64)
    _close_wkv(sT, s_p)
    if dtype == torch.float32:
        _close_wkv(o, o_p)
    else:
        torch.testing.assert_close(o.float(), o_p, rtol=2.0 ** -7,
                                   atol=WKV_ATOL_REL * o_p.abs().max().item())
    o0, _ = K10.rwkv6_heads_cuda(*views, u, None, chunk=64)   # s0 None: zeros
    o0_p, _ = wkv_ref.rwkv6_chunked(*views, u, None, chunk=64)
    torch.testing.assert_close(o0.float(), o0_p, rtol=2.0 ** -7,
                               atol=WKV_ATOL_REL * o0_p.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,d,chunk", [(2, 4, 256, 64, 64), (1, 3, 100, 16, 50)], ids=str)
def test_k10_bf16_instance_at_the_fp32_tolerance(card, B, H, T, d, chunk, rng):
    """The output pass the model's prefill runs (bf16 views in, the bf16
    instance) with o stored in fp32, so no bf16 rounding hides its
    arithmetic: within the K10 tolerance of the plain version on the same
    bf16 views."""
    r, k, v, w, u, s0 = _wkv_problem(rng, B, H, T, d, d, card)
    views = [x.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
             for x in (r, k, v, w)]
    o = K10._heads_out(B, H, T, d, torch.float32, card)
    launches = K10.WKV.launches
    sT = K10._launch(*K10._operands(*views), u, 0, u.stride(0), s0, o, chunk)
    torch.cuda.synchronize()
    assert K10.WKV.launches - launches == 1
    o_p, s_p = wkv_ref.rwkv6_chunked(*views, u, s0, chunk=chunk)
    _close_wkv(o, o_p)
    _close_wkv(sT, s_p)


@pytest.mark.cuda
def test_k10_at_the_clamp(card, rng):
    """Decays at the clamp (w = 1e-26, |L| up to 3.8e3 a chunk): K10 within
    the K10 tolerance of the closed form in fp64 and within 1e-3 of the scan
    oracle.  The fp32 plain version loses the pairs s = t - 1 to
    cancellation there (tests/test_torch_rwkv.py), so it is not the yardstick."""
    B, H, T, d = 1, 4, 512, 64
    r, k, v, w, u, s0 = _wkv_problem(rng, B, H, T, d, d, card)
    w = torch.full_like(w, 1e-26)
    BH = B * H
    o, sT = K10.rwkv6_cuda(*(x.reshape(BH, T, -1) for x in (r, k, v, w)),
                           u.expand(B, H, d).reshape(BH, d), s0.reshape(BH, d, d), chunk=64)
    assert torch.isfinite(o).all() and torch.isfinite(sT).all()
    o_x, s_x = _chunked_f64(r, k, v, w, u, s0, 64)
    _close_wkv(o.reshape(B, H, T, d).double(), o_x)
    _close_wkv(sT.reshape(B, H, d, d).double(), s_x)
    o_s, s_s = wkv_ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o.reshape(B, H, T, d), o_s, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(sT.reshape(B, H, d, d), s_s, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_k10_through_the_op(card, rng):
    """The op's "auto" engine on the card: bf16 head views (not contiguous,
    as the model's _heads makes them) through K10, against the torch engine."""
    B, H, T, d = 2, 4, 80, 16
    r, k, v, w, u, s0 = _wkv_problem(rng, B, H, T, d, d, card)
    views = [x.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
             for x in (r, k, v, w)]
    assert not views[0].is_contiguous()
    launches = K10.WKV.launches
    o, sT = rwkv6(*views, u, s0)
    assert K10.WKV.launches - launches == 1 and o.dtype == torch.bfloat16
    o_t, s_t = rwkv6(*views, u, s0, engine="torch")
    torch.testing.assert_close(o, o_t, rtol=1e-2, atol=1e-2)   # o rounded to bf16
    _close_wkv(sT, s_t)
    with pytest.raises(ValueError, match="chunk from 1 to 64"):
        rwkv6(*views, u, s0, engine="cuda", chunk=80)


@pytest.mark.cuda
def test_rwkv6_smoke_prefill_and_generate_on_card(card, rng):
    """The SMOKE model on the card: the prefill runs K10 once a layer and
    agrees with the torch engine; greedy generation serves in-vocab tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.train.serve_step import build_prefill, generate

    cfg = get_arch("rwkv6-7b", smoke=True)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 48))).to(card)
    launches = K10.WKV.launches
    logits = build_prefill(cfg)(params, {"tokens": tokens})
    assert K10.WKV.launches - launches == cfg.n_layers
    plain = build_prefill(cfg, wkv_engine="torch")(params, {"tokens": tokens})
    assert K10.WKV.launches - launches == cfg.n_layers
    rel = (logits.float() - plain.float()).norm() / plain.float().norm()
    assert torch.isfinite(logits.float()).all() and rel < 1e-2
    out = generate(params, cfg, tokens[:, :8], steps=8, s_max=32)
    assert out.shape == (2, 16) and int(out.max()) < cfg.padded_vocab and int(out.min()) >= 0


# (BKV, rep, S, dh, causal, window): starcoder2's heads (dh 128, rep 9) on a
# ragged S, S 96 and 100 with a window smaller than a kv tile, dh 8 / 16 /
# 64 / 128, rep 1 / 3 / 9, no causal mask with and without a window; the
# tensor-core kernels' edges: dh 72 (not a multiple of 16) with rep 9, S 1,
# S 65 (one key past a tile), a window of 5 (fewer keys than an mma's rows)
FLASH_CASES = [(2, 9, 100, 128, True, 0), (2, 3, 96, 64, True, 32), (1, 1, 100, 8, True, 0),
               (3, 3, 130, 64, False, 0), (1, 9, 256, 128, True, 32), (2, 1, 64, 16, False, 24),
               (1, 9, 130, 72, True, 0), (2, 3, 1, 64, True, 0), (1, 3, 65, 128, True, 0),
               (2, 3, 100, 64, True, 5)]
# fp32: as K10's; bf16: one bf16 ulp of the output (2^-8 to 2^-7 of it, the
# two fp32 results rounding to neighbours), plus the fp32 limit's atol
FLASH_RTOL, FLASH_ATOL_REL = 1e-5, 2e-5


def _check_flash(got, want):
    """K11/K12's output against its plain version's, in their dtype."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    err = (g - w).abs()
    atol = FLASH_ATOL_REL * w.abs().max()
    if got.dtype == torch.float32:
        lim = atol + FLASH_RTOL * w.abs()
    else:
        lim = atol + torch.ldexp(torch.ones_like(w), torch.frexp(torch.maximum(g.abs(), w.abs()))
                                 .exponent - 8)
    assert bool((err <= lim).all()), f"max err {err.max().item()}"


def _flash_problem(rng, BKV, rep, S, dh, dtype, device):
    def n(rows):
        return torch.from_numpy(rng.normal(size=(rows, S, dh)).astype(np.float32)).to(
            device, dtype)
    return n(BKV * rep), n(BKV), n(BKV)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("BKV,rep,S,dh,causal,window", FLASH_CASES, ids=str)
def test_k11_k12_flash(card, BKV, rep, S, dh, causal, window, dtype, rng):
    q, k, v = _flash_problem(rng, BKV, rep, S, dh, dtype, card)
    kw = dict(rep=rep, causal=causal, window=window)
    n11, n12 = KF.FLASH.launches, KF.FLASH_KVCHUNK.launches
    o11 = KF.flash_cuda(q, k, v, **kw)
    o12 = {kvb: KF.flash_kvchunk_cuda(q, k, v, kv_block=kvb, **kw) for kvb in (32, 64)}
    torch.cuda.synchronize()
    assert KF.FLASH.launches - n11 == 1 and KF.FLASH_KVCHUNK.launches - n12 == 2
    _check_flash(o11, KF.flash_plain(q, k, v, **kw))
    for kvb, o in o12.items():
        _check_flash(o, KF.flash_kvchunk_plain(q, k, v, kv_block=kvb, **kw))
    assert torch.isfinite(o11.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_same_bits_on_two_runs(card, dtype, rng):
    """No atomics and a fixed sum order: two runs on the same inputs give
    the same bits (a causal case over several kv tiles, rep 9)."""
    q, k, v = _flash_problem(rng, 2, 9, 200, 128, dtype, card)
    for fn in (KF.flash_cuda, lambda *a, **kw: KF.flash_kvchunk_cuda(*a, kv_block=40, **kw)):
        first = fn(q, k, v, rep=9, window=150)
        assert torch.equal(first, fn(q, k, v, rep=9, window=150))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_head_views_and_the_op(card, dtype, rng):
    """The op on (B, H, S, dh) views of (B, S, H, dh) projections, as the
    model passes them: "auto" runs K11, "cuda_kvchunk" K12, "torch" neither;
    o keeps q's strides; a CPU tensor is refused on the cuda engines."""
    B, KV, rep, S, dh = 2, 2, 3, 72, 32
    x = [torch.from_numpy(rng.normal(size=(B, S, h, dh)).astype(np.float32)).to(card, dtype)
         for h in (KV * rep, KV, KV)]
    q, k, v = (t.permute(0, 2, 1, 3) for t in x)
    assert not q.is_contiguous()
    n11, n12 = KF.FLASH.launches, KF.FLASH_KVCHUNK.launches
    o = flash_attention(q, k, v, rep=rep, window=20)
    assert KF.FLASH.launches - n11 == 1 and o.stride() == q.stride()
    o12 = flash_attention(q, k, v, rep=rep, window=20, engine="cuda_kvchunk", kv_block=24)
    assert KF.FLASH_KVCHUNK.launches - n12 == 1
    o_t = flash_attention(q, k, v, rep=rep, window=20, engine="torch")
    assert KF.FLASH.launches - n11 == 1 and KF.FLASH_KVCHUNK.launches - n12 == 1
    _check_flash(o, o_t)
    _check_flash(o12, KF.flash_kvchunk_plain(q, k, v, rep=rep, window=20, kv_block=24))
    grouped = [t.contiguous().reshape(-1, S, dh) for t in (q, k, v)]
    assert torch.equal(KF.flash_cuda(*grouped, rep=rep, window=20), o.reshape(-1, S, dh))
    for engine in ("cuda", "cuda_kvchunk"):
        with pytest.raises(ValueError, match="CUDA device"):
            flash_attention(*(t.cpu() for t in grouped), rep=rep, engine=engine)


@pytest.mark.cuda
def test_flash_wrappers_refuse_what_they_do_not_take(card):
    q = torch.zeros((3, 16, 160), device=card)
    with pytest.raises(ValueError, match="head sizes 1 to 128"):
        KF.flash_cuda(q, q[:1], q[:1], rep=3)
    q = torch.zeros((3, 16, 8), device=card)
    with pytest.raises(ValueError, match="must share"):
        KF.flash_cuda(q, q[:1].to(torch.bfloat16), q[:1].to(torch.bfloat16), rep=3)
    with pytest.raises(ValueError, match="stride"):
        KF.flash_kvchunk_cuda(q, q[:1].transpose(1, 2).contiguous().transpose(1, 2)[:, :, :8],
                              q[:1], rep=3)
    # bf16 rows must start on 16 bytes: a view one element in, and rows of 4
    x = torch.zeros((3, 16, 16), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        KF.flash_cuda(x[..., 1:9], x[:1, :, :8], x[:1, :, :8], rep=3)
    x = torch.zeros((3, 16, 4), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        KF.flash_kvchunk_cuda(x, x[:1], x[:1], rep=3)


@pytest.mark.cuda
def test_starcoder2_smoke_prefill_on_card(card, rng, monkeypatch):
    """The SMOKE model on the card: the dense branch runs K11 once a layer,
    the blockwise branch (forced from 32 tokens) K12 once a layer, both
    against the torch engine; greedy generation serves in-vocab tokens."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import attention, init_params
    from repro_torch.train.serve_step import build_prefill, generate

    cfg = dataclasses.replace(get_arch("starcoder2-7b", smoke=True), dtype=torch.float32)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 96))).to(card)
    for threshold, kern in ((8192, KF.FLASH), (32, KF.FLASH_KVCHUNK)):
        monkeypatch.setattr(attention, "BLOCKWISE_MIN_SEQ", threshold)
        launches = kern.launches
        logits = build_prefill(cfg)(params, {"tokens": tokens})
        assert kern.launches - launches == cfg.n_layers
        plain = build_prefill(cfg, attn_engine="torch")(params, {"tokens": tokens})
        torch.testing.assert_close(logits, plain, rtol=1e-4,
                                   atol=1e-5 * plain.abs().max().item())
    out = generate(params, cfg, tokens[:, :8], steps=8, s_max=32)
    assert out.shape == (2, 16) and int(out.max()) < cfg.padded_vocab and int(out.min()) >= 0


# -- layouts: every lattice kernel in AoS and AoSoA against its SoA launch ----------
#
# A thread owns the same site (or element) in every layout and only the
# address changes, so every field output and every sum must equal the SoA
# launch's bitwise; against the plain version the usual tolerances hold.
# aosoa6 runs the kernels' division path (a SAL that is not a power of two).

CARD_LAYOUTS = ["aos", "aosoa4", "aosoa8", "aosoa32", "aosoa128", "aosoa6"]
MILC_LAT, LB_LAT = (4, 4, 6, 8), (8, 6, 8)   # 768 and 384 sites: every SAL above divides


def _vvl(lay):
    """The smallest block that is a whole number of warps and short arrays."""
    return 32 * lay.sal // int(np.gcd(32, lay.sal)) if lay.kind.value == "aosoa" else 32


def _same(got_phys, lay, want_soa, name):
    got = lay.unpack(got_phys)
    assert torch.equal(got, want_soa), f"{name} in {lay.name}: max err {(got - want_soa).abs().max()}"


def _milc_inputs(rng, card):
    V = int(np.prod(MILC_LAT))
    x, y, p, ap = (_dev(rng, (24, V), card) for _ in range(4))
    u = torch.from_numpy(fields.random_su3_gauge(MILC_LAT, seed=2).reshape(72, -1)).to(card)
    return V, x, y, p, ap, u


@pytest.mark.cuda
def test_wilson_normal_policy_same_bits_run_to_run(card):
    """K5's policy instance, single and over 4 slots, at (64, 64, 64, 32)
    (phase 3's lattice: 65,536 blocks): ap and pap bitwise equal over 8
    runs on the same inputs.  A race between a block's warps or between
    its slots' folds would show as a run that differs."""
    from repro_torch.core.plan import CudaPolicy

    lat = (64, 64, 64, 32)
    V = int(np.prod(lat))
    gen = torch.Generator(device=card).manual_seed(5)
    p = torch.randn((24, V), generator=gen, device=card)
    u16 = K.bf16_pack_cuda(0.3 * torch.randn((72, V), generator=gen, device=card))
    p4 = torch.stack([p, p.flip(0), p * 0.5, -p])
    pol = CudaPolicy(True, True)
    for x, batched in ((p, False), (p4, True)):
        first = K.wilson_normal_cuda(x, u16, 0.12, lat, 128, batched=batched, policy=pol)
        for _ in range(8):
            again = K.wilson_normal_cuda(x, u16, 0.12, lat, 128, batched=batched, policy=pol)
            assert all(_bits(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", CARD_LAYOUTS)
def test_milc_kernels_in_each_layout_equal_soa(card, spec, rng):
    lay = parse_layout(spec)
    vvl = _vvl(lay)
    V, x, y, p, ap, u = _milc_inputs(rng, card)
    a = torch.tensor(0.3, device=card)
    def L(*names):
        return {n: lay for n in names}

    xl, yl, pl, apl, ul = (lay.pack(t) for t in (x, y, p, ap, u))
    # K1
    _same(target.site_g5(xl, 12, vvl, layouts=L("x")), lay, target.site_g5(x, 12, vvl), "g5")
    assert torch.equal(target.site_g5(xl, 12, vvl, layouts=L("x")),
                       target.g5_plain(xl, 12, L("x")))
    _same(target.site_mul(xl, yl, vvl, layouts=L("x", "y")), lay,
          target.site_mul(x, y, vvl), "mul")
    _same(target.site_axpy(0.5, xl, yl, vvl, layouts=L("x", "y")), lay,
          target.site_axpy(0.5, x, y, vvl), "axpy")
    # K2 and its fold
    for op in ("sum", "max"):
        assert torch.equal(reduce.reduce_sites(xl, op, vvl, layouts=L("x")),
                           reduce.reduce_sites(x, op, vvl))
    _close_sum(reduce.reduce_sites(xl, "sum", vvl, layouts=L("x")), x.sum(dim=1), x)
    # K3
    Lcg = L("x", "r", "p", "ap")
    got = fuse.cg_update(xl, yl, pl, apl, a, -a, vvl, layouts=Lcg)
    want = fuse.cg_update(x, y, p, ap, a, -a, vvl)
    _same(got[0], lay, want[0], "cg_update x_new")
    _same(got[1], lay, want[1], "cg_update r_new")
    assert torch.equal(got[2], want[2])
    plain = fuse.cg_update_plain(xl, yl, pl, apl, a, -a, Lcg)
    _close_field(lay.unpack(got[1]), lay.unpack(plain[1]))
    _same(fuse.cg_xpay(xl, yl, a, vvl, layouts=L("x", "y")), lay, fuse.cg_xpay(x, y, a, vvl),
          "cg_xpay")
    # K4, K5
    _same(K.dslash_cuda(xl, ul, MILC_LAT, vvl, layouts=L("psi", "u")), lay,
          K.dslash_cuda(x, u, MILC_LAT, vvl), "dslash")
    _close_field(lay.unpack(K.dslash_cuda(xl, ul, MILC_LAT, vvl, layouts=L("psi", "u"))),
                 lay.unpack(K.dslash_plain(xl, ul, MILC_LAT, L("psi", "u"))))
    ap_l, pap_l = K.wilson_normal_cuda(xl, ul, 0.12, MILC_LAT, vvl, layouts=L("p", "u"))
    ap_s, pap_s = K.wilson_normal_cuda(x, u, 0.12, MILC_LAT, vvl)
    _same(ap_l, lay, ap_s, "wilson_normal ap")
    assert torch.equal(pap_l, pap_s)


def _lb_inputs(rng, card, lat=LB_LAT):
    V = int(np.prod(lat))
    return (V, _dev(rng, (19, V), card, 0.1, 1.0), _dev(rng, (3, V), card, 0.01),
            *(_dev(rng, (5, V), card, 0.05) for _ in range(4)),
            _dev(rng, (15, V), card, 0.02), _dev(rng, (9, V), card, 0.01))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", CARD_LAYOUTS)
def test_ludwig_kernels_in_each_layout_equal_soa(card, spec, rng):
    lay = parse_layout(spec)
    vvl = _vvl(lay)
    V, f, g, q, lapq, h, adv, dq, w = _lb_inputs(rng, card)
    fl, gl = lay.pack(f), lay.pack(g)
    # K7 with force in the field's layout and in SoA (its own layout)
    for force_lay in (lay, SOA):
        L = {"dist": lay, "force": force_lay, "out": lay}
        c = K7.collide_cuda(fl, force_lay.pack(g), 0.8, vvl, layouts=L)
        _same(c, lay, K7.collide_cuda(f, g, 0.8, vvl), "collide")
        _close_field(lay.unpack(c), K7.collide_plain(f, g, 0.8))
    # K8 moves data only: bitwise against its plain version too
    p = K8.propagate_cuda(fl, LB_LAT, vvl, layouts={"dist": lay})
    _same(p, lay, K8.propagate_cuda(f, LB_LAT, vvl), "propagate")
    assert torch.equal(p, K8.propagate_plain(fl, LB_LAT, {"dist": lay}))
    # K5L
    L = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
    d2, u = K8.lb_step_cuda(fl, gl, 0.8, LB_LAT, vvl, layouts=L)
    d2s, us = K8.lb_step_cuda(f, g, 0.8, LB_LAT, vvl)
    _same(d2, lay, d2s, "lb_step dist2")
    _same(u, lay, us, "lb_step u")
    only2, none = K8.lb_step_cuda(fl, gl, 0.8, LB_LAT, vvl, with_u=False, layouts=L)
    assert none is None and torch.equal(only2, d2)
    # K3L and K1L
    ql, lapl, hl, advl, dql, wl = (lay.pack(t) for t in (q, lapq, h, adv, dq, w))
    kw = dict(a0=0.01, gamma=3.0, kappa_m=0.01, kappa_s=0.01, xi=0.7)
    Lc = {"q": lay, "lapq": lay, "dq": lay}
    got = LK.chem_stress_cuda(ql, lapl, dql, vvl=vvl, layouts=Lc, **kw)
    want = LK.chem_stress_cuda(q, lapq, dq, vvl=vvl, **kw)
    _same(got[0], lay, want[0], "chem_stress h")
    _same(got[1], lay, want[1], "chem_stress sigma")
    kw = dict(gamma_rot=0.3, xi=0.7, dt=1.0)
    Lu = {"q": lay, "h": lay, "w": lay, "adv": lay}
    _same(LK.lc_update_cuda(ql, hl, wl, advl, vvl=vvl, layouts=Lu, **kw), lay,
          LK.lc_update_cuda(q, h, w, adv, vvl=vvl, **kw), "lc_update")
    kw = dict(a0=0.01, gamma=3.0, kappa=0.01)
    _same(LK.fed_cuda(ql, dql, vvl=vvl, layouts={"q": lay, "dq": lay}, **kw), lay,
          LK.fed_cuda(q, dq, vvl=vvl, **kw), "fed")


@pytest.mark.cuda
def test_kernels_take_mixed_layouts(card, rng):
    """Every input and output in a layout of its own, on ragged blocks."""
    aos, a4, a8, a32 = (parse_layout(s) for s in ("aos", "aosoa4", "aosoa8", "aosoa32"))
    V, x, y, p, ap, u = _milc_inputs(rng, card)
    a = torch.tensor(0.3, device=card)
    vvl = 96     # a block of 3 warps: 24 short arrays of 4, 12 of 8, 3 of 32
    L = {"x": aos, "y": SOA, "out": a8}
    _same(target.site_mul(aos.pack(x), y, vvl, layouts=L), a8, x * y, "mul")
    _same(target.site_g5(x, 12, vvl, layouts={"x": SOA, "out": aos}), aos,
          target.g5_plain(x, 12), "g5")
    L = {"x": aos, "r": a8, "p": SOA, "ap": a32, "x_new": a4, "r_new": aos}
    ins = [L[n].pack(t) for n, t in zip(("x", "r", "p", "ap"), (x, y, p, ap))]
    got = fuse.cg_update(*ins, a, -a, vvl, layouts=L)
    want = fuse.cg_update(x, y, p, ap, a, -a, vvl)
    _same(got[0], a4, want[0], "cg_update x_new")
    _same(got[1], aos, want[1], "cg_update r_new")
    assert torch.equal(got[2], want[2])
    L = {"x": a8, "y": aos, "out": SOA}
    _same(fuse.cg_xpay(a8.pack(x), aos.pack(y), a, vvl, layouts=L), SOA,
          fuse.cg_xpay(x, y, a, vvl), "cg_xpay")
    L = {"psi": aos, "u": SOA, "out": a8}
    _same(K.dslash_cuda(aos.pack(x), u, MILC_LAT, vvl, layouts=L), a8,
          K.dslash_cuda(x, u, MILC_LAT, vvl), "dslash")
    L = {"p": a8, "u": aos, "ap": SOA}
    ap_l, pap_l = K.wilson_normal_cuda(a8.pack(x), aos.pack(u), 0.1, MILC_LAT, vvl, layouts=L)
    ap_s, pap_s = K.wilson_normal_cuda(x, u, 0.1, MILC_LAT, vvl)
    assert torch.equal(ap_l, ap_s) and torch.equal(pap_l, pap_s)
    V, f, g, q, lapq, h, adv, dq, w = _lb_inputs(rng, card, (3, 5, 7))   # 105 sites
    L = {"dist": aos, "force": SOA, "dist2": SOA, "u": aos}
    d2, uu = K8.lb_step_cuda(aos.pack(f), g, 0.8, (3, 5, 7), 32, layouts=L)
    d2s, us = K8.lb_step_cuda(f, g, 0.8, (3, 5, 7), 32)
    assert torch.equal(d2, d2s)
    _same(uu, aos, us, "lb_step u")
    L = {"q": aos, "h": SOA, "w": aos, "adv": SOA, "q_new": aos}
    kw = dict(gamma_rot=0.3, xi=0.7, dt=1.0)
    _same(LK.lc_update_cuda(aos.pack(q), h, aos.pack(w), adv, vvl=32, layouts=L, **kw), aos,
          LK.lc_update_cuda(q, h, w, adv, vvl=32, **kw), "lc_update")
    L = {"q": SOA, "lapq": aos, "dq": SOA, "h": aos, "sigma": SOA}
    kw = dict(a0=0.01, gamma=3.0, kappa_m=0.01, kappa_s=0.01, xi=0.7)
    got = LK.chem_stress_cuda(q, aos.pack(lapq), dq, vvl=32, layouts=L, **kw)
    want = LK.chem_stress_cuda(q, lapq, dq, vvl=32, **kw)
    _same(got[0], aos, want[0], "chem_stress h")
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_non_soa_launches_run_only_the_hand_kernels(card, rng):
    """torch.profiler over AoS launches of g5, cg_update, dslash and the LB
    half-step through the engine: the device ran the hand kernels (and
    K2's fold) and no copy or elementwise kernel."""
    from torch.profiler import ProfilerActivity, profile

    aos = parse_layout("aos")
    cfg = TargetConfig("cuda", device="cuda")
    V, x, y, p, ap, u = _milc_inputs(rng, card)
    fx, fy, fp, fap = (Field.from_canonical(n, t, MILC_LAT, aos)
                       for n, t in zip(("x", "r", "p", "ap"), (x, y, p, ap)))
    fu = Field.from_canonical("u", u, MILC_LAT, aos)
    _, f, g, *_ = _lb_inputs(rng, card)
    fd, fg = Field.from_canonical("dist", f, LB_LAT, aos), Field.from_canonical("force", g, LB_LAT, aos)
    scal = {"alpha": torch.tensor(0.3, device=card), "neg_alpha": torch.tensor(-0.3, device=card)}
    lcfg = LD.LudwigConfig(lattice=LB_LAT, layout=aos, target=cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        CG.g5(fx, cfg)
        CG.cg_update_graph(24).launch({"x": fx, "r": fy, "p": fp, "ap": fap}, scalars=scal,
                                      config=cfg, outputs=("x_new", "r_new", "rr"))
        dslash(fx, fu, config=cfg)
        LD.lb_step_graph(lcfg).launch({"dist": fd, "force": fg}, config=cfg,
                                      outputs=("dist2", "u"))
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    hand = ("site_g5_kernel", "cg_update_vec_kernel", "reduce_fold_kernel", "dslash_kernel",
            "lb_step_kernel")
    assert all(any(k in n for n in names) for k in hand), names
    assert all(any(k in n for k in hand) for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["aos", "aosoa16"])
def test_drivers_in_a_layout_equal_soa(card, spec):
    lay = parse_layout(spec)
    kw = dict(lattice=(16, 16, 16, 16), kappa=0.12, tol=1e-10, max_iter=2000)
    scfg = MilcConfig(target=TargetConfig("cuda", device="cuda"), **kw)
    lcfg = MilcConfig(layout=lay, target=TargetConfig("cuda", device="cuda"), **kw)
    u, b = init_problem(scfg)
    rs = solve(scfg, u, b)
    rl = solve(lcfg, u.as_layout(lay), b.as_layout(lay))
    assert rl.iterations == rs.iterations and rl.x.layout == lay
    assert torch.equal(rl.x.canonical(), rs.x.data)
    s_cfg = LudwigConfig(lattice=(32, 32, 32), target=TargetConfig("cuda", device="cuda"))
    l_cfg = LudwigConfig(lattice=(32, 32, 32), layout=lay,
                         target=TargetConfig("cuda", device="cuda"))
    s = init_state(s_cfg, seed=0)
    t = LD.LudwigState(dist=s.dist.as_layout(lay), q=s.q.as_layout(lay))
    for _ in range(5):
        s, t = step(s, s_cfg), step(t, l_cfg)
    assert t.dist.layout == lay and t.q.layout == lay
    assert torch.equal(t.dist.canonical(), s.dist.data)
    assert torch.equal(t.q.canonical(), s.q.data)


@pytest.mark.cuda
def test_sal_not_dividing_vvl_refused_before_any_launch(card, rng):
    lay = parse_layout("aosoa64")
    x = Field.from_canonical("x", _dev(rng, (24, 512), card), (8, 8, 8), lay)
    launches = target.G5.launches
    with pytest.raises(ValueError, match="multiple of AoSoA sal=64"):
        CG.g5(x, TargetConfig("cuda", device="cuda", plan_policy=target.LoweringPlan("cuda", 32)))
    assert target.G5.launches == launches
    # the default plan aligns the block to the SAL instead
    assert CG.g5(x, TargetConfig("cuda", device="cuda", vvl=32)).layout == lay
    assert target.G5.launches == launches + 1


# -- the batch instances (K3B, K5B, K2B) and batched serving ------------------------

BATCH_LAYOUTS = ["soa", "aos", "aosoa16"]


def _bits(a, b):
    """Bitwise equality, NaN included (torch.equal calls NaN unequal)."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _batch_inputs(rng, card, lay, V):
    """x, r, p, ap: 4 stacked spinors in ``lay``; slot 1 is frozen (mask 0),
    slot 2 all-zero, slot 3 frozen with -0.0 and a NaN in its x and r (the
    y inputs the select passes through); alpha, neg_alpha, m: (4,)."""
    canon = [torch.from_numpy(rng.normal(size=(4, 24, V)).astype(np.float32)) for _ in range(4)]
    for t in canon:
        t[2] = 0.0
    x, r = canon[0], canon[1]
    x[3, 0, 5] = r[3, 7, 11] = -0.0
    x[3, 9, 2] = r[3, 1, 0] = float("nan")
    phys = [torch.stack([lay.pack(c) for c in t]).to(card) for t in canon]
    alpha = torch.tensor([0.37, -1.5, 0.25, 2.0], device=card)
    m = torch.tensor([1.0, 0.0, 1.0, 0.0], device=card)
    return phys, alpha, -alpha, m


@pytest.mark.cuda
@pytest.mark.parametrize("spec", BATCH_LAYOUTS)
def test_batch_kernels_per_slot_bitwise_and_close_to_plain(card, spec, rng):
    """K3B (cg_update_masked, cg_xpay_masked, dot_prod), K2B (the batched
    sum and fold) and K5B (wilson_normal): each slot bitwise the single
    kernel on that slot, frozen slots bitwise their y inputs, and within
    tolerance of the plain versions."""
    lay = parse_layout(spec)
    V = int(np.prod(MILC_LAT))
    lays = {n: lay for n in ("x", "r", "p", "ap")}
    (x, r, p, ap), alpha, neg_alpha, m = _batch_inputs(rng, card, lay, V)
    bx, br, brr = fuse.cg_update_masked(x, r, p, ap, alpha, neg_alpha, m, 128, layouts=lays)
    wx, wr, wrr = fuse.cg_update_masked_plain(x, r, p, ap, alpha, neg_alpha, m, lays)
    for b in (0, 2):
        sx, sr, srr = fuse.cg_update(x[b], r[b], p[b], ap[b], alpha[b], neg_alpha[b], 128,
                                     layouts=lays)
        assert _bits(bx[b], sx) and _bits(br[b], sr) and _bits(brr[b], srr)
        _close_field(lay.unpack(bx[b]), lay.unpack(wx[b]))
        _close_field(lay.unpack(br[b]), lay.unpack(wr[b]))
        _close_sum(brr[b], wrr[b], lay.unpack(wr[b]) ** 2)
    for b in (1, 3):
        assert _bits(bx[b], x[b]) and _bits(br[b], r[b])
    xy = {"x": lay, "y": lay}
    out = fuse.cg_xpay_masked(p, r, alpha, m, 128, layouts=xy)
    for b in (0, 2):
        assert _bits(out[b], fuse.cg_xpay(p[b], r[b], alpha[b], 128, layouts=xy))
        _close_field(lay.unpack(out[b]), lay.unpack(r[b]) + alpha[b] * lay.unpack(p[b]))
    for b in (1, 3):
        assert _bits(out[b], r[b])
    shared = fuse.cg_xpay_masked(p, r[0], alpha, m, 128, layouts=xy)  # one y for every slot
    for b in range(4):
        want = fuse.cg_xpay(p[b], r[0], alpha[b], 128, layouts=xy) if b in (0, 2) else r[0]
        assert _bits(shared[b], want)
    prod = target.site_mul(x, r, 128, layouts=xy, batch=4)
    assert _bits(prod, target.mul_plain(x, r, xy, batch=4))
    sums = reduce.reduce_sites_batched(prod, "sum", 128, layouts={"x": lay})
    for b in range(4):
        assert _bits(prod[b], target.site_mul(x[b], r[b], 128, layouts=xy))
        assert _bits(sums[b], reduce.reduce_sites(prod[b], "sum", 128, layouts={"x": lay}))
    for b in (0, 1, 2):
        c = lay.unpack(prod[b])
        _close_sum(sums[b], c.sum(dim=1), c)
    assert _bits(reduce.reduce_sites_batched(prod, "max", 128, layouts={"x": lay})[0],
                 lay.unpack(prod[0]).amax(dim=1))
    u = lay.pack(torch.from_numpy(fields.random_su3_gauge(MILC_LAT, seed=2).reshape(72, -1))
                 .to(card))
    pw = p[[0, 2, 1]]
    ap_b, pap_b = K.wilson_normal_cuda(pw, u, 0.12, MILC_LAT, 128, layouts={"p": lay, "u": lay},
                                       batched=True)
    want_ap, want_pap = K.wilson_normal_plain(pw, u, 0.12, MILC_LAT, {"p": lay, "u": lay},
                                              batched=True)
    for b in range(3):
        ap1, pap1 = K.wilson_normal_cuda(pw[b], u, 0.12, MILC_LAT, 128,
                                         layouts={"p": lay, "u": lay})
        assert _bits(ap_b[b], ap1) and _bits(pap_b[b], pap1)
        _close_field(lay.unpack(ap_b[b]), lay.unpack(want_ap[b]))
        _close_sum(pap_b[b], want_pap[b], lay.unpack(pw[b]) * lay.unpack(want_ap[b]))
    parts = _dev(rng, (4, 6, 24), card)
    folded = reduce.fold_partials_batched(parts, "sum")
    for b in range(4):
        assert _bits(folded[b], reduce.fold_partials(parts[b], "sum"))


def _serve_sources(cfg, u, n):
    """n sources: random, one spectrally filtered (converges earlier), the
    last all-zero (an empty slot)."""
    bs = [Field.from_numpy("b", fields.random_spinor(cfg.lattice, seed=10 + i), cfg.lattice,
                           cfg.layout, device="cuda") for i in range(n)]
    _, _, normal = CG.make_wilson_op(u, cfg.kappa, cfg.target)
    f = bs[1]
    for _ in range(6):
        f = normal(f)
    bs[1] = f.with_data(f.data / torch.linalg.norm(f.data))
    bs[-1] = bs[-1].with_data(torch.zeros_like(bs[-1].data))
    return bs


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aosoa16"])
def test_solve_batched_on_card_bitwise_vs_solve(card, spec):
    """solve_batched on "cuda" (K5B, K3B, K2B): each live slot's x,
    iterations and residual bitwise the cuda solve of its source alone; the
    empty slot takes 0 iterations and returns x = 0."""
    from repro_torch.apps.milc import driver

    lay = parse_layout(spec)
    cfg = MilcConfig(lattice=(8, 8, 8, 8), kappa=0.12, tol=1e-10, max_iter=2000, layout=lay,
                     target=TargetConfig("cuda", device="cuda"))
    u, _ = init_problem(cfg, seed=0)
    bs = _serve_sources(cfg, u, 4)
    res = driver.solve_batched(cfg, u, bs)
    its = res.iterations.tolist()
    assert its[1] < its[0] and its[3] == 0 and not res.x.element(3).data.any()
    for i in range(3):
        r1 = solve(cfg, u, bs[i])
        assert torch.equal(res.x.element(i).data, r1.x.data)
        assert its[i] == r1.iterations and torch.equal(res.residual[i], r1.residual)
        assert residual_check(cfg, u, bs[i], res.x.element(i)) < 1e-3


@pytest.mark.cuda
def test_solve_server_on_card_bitwise_vs_solve(card):
    """A mixed-shape SolveServer drain on the card, more requests than
    slots: every outcome bitwise the dedicated cuda solve."""
    from repro_torch.launch.serve import SolveRequest, SolveServer

    cfgs = {lat: MilcConfig(lattice=lat, kappa=0.12, tol=1e-10, max_iter=2000,
                            target=TargetConfig("cuda", device="cuda"))
            for lat in ((8, 8, 8, 8), (4, 4, 8, 8))}
    server = SolveServer(TargetConfig("cuda", device="cuda"), slots=2, tol=1e-10, max_iter=2000)
    reqs, us = [], {}
    for i, (lat, cfg) in enumerate(cfgs.items()):
        us[lat], _ = init_problem(cfg, seed=i)
        server.register(us[lat], cfg.kappa)
        reqs += [SolveRequest(10 * i + j, b) for j, b in enumerate(_serve_sources(cfg, us[lat], 3))]
    for req in sorted(reqs, key=lambda q: q.rid % 10):
        server.submit(req)
    results = server.run()
    for req in reqs:
        lat = req.b.lattice
        want = solve(cfgs[lat], us[lat], req.b)
        got = results[req.rid]
        assert torch.equal(got.x.data, want.x.data) and got.iterations == want.iterations
        assert got.residual == float(want.residual) or want.iterations == 0


@pytest.mark.cuda
def test_batched_iteration_runs_only_the_hand_kernels(card):
    """torch.profiler over one batched CG iteration on "cuda": the device ran
    K5B, K3B and K2B's fold, and no PyTorch arithmetic touched a
    lattice-sized tensor (the plain versions never ran; the scalar guards
    and the component fold work on (batch,) and (batch, 24) tensors)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import BatchedField

    cfg = MilcConfig(lattice=(8, 8, 8, 8), kappa=0.12, tol=1e-10, max_iter=2000,
                     target=TargetConfig("cuda", device="cuda"))
    u, _ = init_problem(cfg, seed=0)
    _, apply_mdag, _ = CG.make_wilson_op(u, cfg.kappa, cfg.target)
    rhs = BatchedField.stack([apply_mdag(b) for b in _serve_sources(cfg, u, 4)])
    state = CG.batched_cg_state(rhs, cfg.target)
    normal = CG.make_fused_normal(u, cfg.kappa, cfg.target)
    state = CG.batched_cg_iteration(state, normal, config=cfg.target, tol=1e-10, max_iter=2000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        CG.batched_cg_iteration(state, normal, config=cfg.target, tol=1e-10, max_iter=2000)
        torch.cuda.synchronize()
    events = prof.key_averages(group_by_input_shape=True)
    names = [e.key for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    hand = ("wilson_normal_t_kernel", "wilson_normal_ap_kernel", "cg_update_vec_kernel",
            "cg_xpay_vec_kernel", "reduce_fold_kernel")
    assert all(any(k in n for n in names) for k in hand), names
    arith = ("aten::add", "aten::mul", "aten::sub", "aten::where", "aten::sum", "aten::cat",
             "aten::stack", "aten::copy_", "aten::clone", "aten::roll", "aten::index")
    big = [(e.key, e.input_shapes) for e in events if e.key in arith
           and any(int(np.prod(s)) > 4 * 24 for s in e.input_shapes if s)]
    assert not big, big


# -- mixed precision: the policy instances (A: K5/K5B, B: K5L, C: K3/K3B fed a
# bf16 ap, D: K2's compensated sum) -------------------------------------------

POLICY_LAYOUTS = ["soa", "aos", "aosoa16"]
ORACLE_RTOL = 2.5e-7   # |sum - fp64 sum| <= ORACLE_RTOL * sum|terms| + 1e-6 (tests/test_dtype.py)


def _oracle_sum(got, terms):
    """got (..., ncomp) within the oracle bound of the fp64 sum of terms
    (..., ncomp, sites)."""
    t = terms.double()
    err = (got.double() - t.sum(dim=-1)).abs()
    assert bool((err <= ORACLE_RTOL * t.abs().sum(dim=-1) + 1e-6).all()), err.max()


def _within_bf16_ulp(got, want):
    """got and want (bf16 or fp32) at most one bf16 ulp apart everywhere,
    plus the fp32 field tolerance FIELD_RTOL x max|want|: fp32 results that
    differ in their last bits round to neighbouring bf16 values, and where a
    value cancels far below its terms the fp32 difference is the larger."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    lim = torch.exp2(torch.floor(torch.log2(mag)) - 7) + FIELD_RTOL * w.abs().max()
    assert bool(((g - w).abs() <= lim).all()), ((g - w).abs() / lim).max()


@pytest.mark.cuda
def test_bf16_rounding_bitwise_torch(card, rng):
    """The policy instances' stage-in rounding is torch's .to(bfloat16) on
    the card, bit for bit: exact ties either way, -0.0, infinities, NaN,
    subnormals and values that round up to infinity; so is the bf16 copy
    of u (bf16_pack) at sizes with a tail and on a misaligned field."""
    special = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), -0.0, 0.0,
                            float("inf"), -float("inf"), float("nan"), 1e-40, -1e-39,
                            3.3961e38, 3.4e38, 2 ** -126, 1.5 * 2 ** -133],
                           dtype=torch.float32)
    x = torch.cat([special, torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 100)])
    x = x.to(card)
    assert _bits(K.bf16_round_cuda(x), x.to(torch.bfloat16).to(torch.float32))
    # the operator's bf16 copy of u: vectors, a tail, and a misaligned field
    for t in (x, x[:4093].contiguous(), _misaligned(x[:4097])):
        got = K.bf16_pack_cuda(t)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), t.to(torch.bfloat16).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", POLICY_LAYOUTS)
def test_wilson_normal_policy_instance(card, spec, rng):
    """A: K5's policy instance in each layout.  The empty policy and an fp32
    storage run the policy-free fields bitwise; bf16 storage gives ap in
    bf16 within one bf16 ulp of the plain version, pap within the oracle
    bound, the same bits on a second run; K5B's slots bitwise K5's; the
    compensated pap beats nothing it need not (within the bound of the fp64
    sum of the kernel's own terms)."""
    from repro_torch.core.plan import CudaPolicy

    lay = parse_layout(spec)
    V, _, _, p, _, u = _milc_inputs(rng, card)
    pp, up = lay.pack(p), lay.pack(u)
    lays = {"p": lay, "u": lay, "ap": lay}
    ap0, pap0 = K.wilson_normal_cuda(pp, up, 0.12, MILC_LAT, 128, layouts=lays)
    a, s = K.wilson_normal_cuda(pp, up, 0.12, MILC_LAT, 128, layouts=lays,
                                policy=CudaPolicy(False, False))
    assert _bits(a, ap0) and _bits(s, pap0)
    a32, s32 = K.wilson_normal_cuda(pp, up, 0.12, MILC_LAT, 128, layouts=lays,
                                    policy=CudaPolicy(False, True))
    assert _bits(a32, ap0)
    _oracle_sum(s32, p * lay.unpack(ap0))
    pol = CudaPolicy(True, True)
    up16 = K.bf16_pack_cuda(up)   # the operator's copy of u, which bf16 storage reads
    ap, pap = K.wilson_normal_cuda(pp, up16, 0.12, MILC_LAT, 128, layouts=lays, policy=pol)
    assert ap.dtype == torch.bfloat16 and pap.dtype == torch.float32
    wap, wpap = K.wilson_normal_plain(pp, up, 0.12, MILC_LAT, lays, policy=pol)
    _within_bf16_ulp(lay.unpack(ap), lay.unpack(wap))
    # pap's terms: the rounded p times the fp32 ap (the plain version's)
    ap32, _ = K.wilson_normal_plain(K.bf16_round(pp), K.bf16_round(up), 0.12, MILC_LAT, lays)
    _oracle_sum(pap, K.bf16_round(p) * lay.unpack(ap32))
    _oracle_sum(wpap, K.bf16_round(p) * lay.unpack(ap32))
    ap2, pap2 = K.wilson_normal_cuda(pp, up16, 0.12, MILC_LAT, 128, layouts=lays, policy=pol)
    assert _bits(ap2, ap) and _bits(pap2, pap)
    pb = torch.stack([pp, lay.pack(p.flip(0)), pp])
    apb, papb = K.wilson_normal_cuda(pb, up16, 0.12, MILC_LAT, 128, layouts=lays, batched=True,
                                     policy=pol)
    for b in range(3):
        one = K.wilson_normal_cuda(pb[b], up16, 0.12, MILC_LAT, 128, layouts=lays, policy=pol)
        assert _bits(apb[b], one[0]) and _bits(papb[b], one[1])


@pytest.mark.cuda
@pytest.mark.parametrize("spec", POLICY_LAYOUTS)
def test_lb_step_policy_instance(card, spec, rng):
    """B: K5L's policy instance: dist2 and u in bf16 within one bf16 ulp of
    the plain version; the same bits on a second run."""
    lay = parse_layout(spec)
    V = int(np.prod(LB_LAT))
    w = torch.tensor([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12)[:, None]
    dist = (w * (1 + 0.1 * torch.from_numpy(rng.normal(size=(19, V)).astype(np.float32)))).to(card)
    force = _dev(rng, (3, V), card, scale=1e-3)
    lays = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
    d, f = lay.pack(dist), lay.pack(force)
    d2, u = K8.lb_step_cuda(d, f, 0.8, LB_LAT, 128, layouts=lays, bf16=True)
    assert d2.dtype == torch.bfloat16 and u.dtype == torch.bfloat16
    wd2, wu = K8.lb_step_plain(d, f, 0.8, LB_LAT, layouts=lays, bf16=True)
    _within_bf16_ulp(lay.unpack(d2), lay.unpack(wd2))
    _within_bf16_ulp(lay.unpack(u), lay.unpack(wu))
    again = K8.lb_step_cuda(d, f, 0.8, LB_LAT, 128, layouts=lays, bf16=True)
    assert _bits(again[0].float(), d2.float()) and _bits(again[1].float(), u.float())


@pytest.mark.cuda
@pytest.mark.parametrize("spec", POLICY_LAYOUTS)
def test_cg_update_bf16_ap_instances(card, spec, rng):
    """C: K3 and K3B fed a bf16 ap: x_new and r_new fp32 within FIELD_RTOL
    of the plain version and bitwise K3 on the widened ap; K3B's live slots
    bitwise K3's, frozen slots bitwise their inputs; an fp16 ap raises."""
    lay = parse_layout(spec)
    V, x, y, p, ap, _ = _milc_inputs(rng, card)
    lays = {n: lay for n in ("x", "r", "p", "ap")}
    xs, ys, ps = (lay.pack(t) for t in (x, y, p))
    ap16 = lay.pack(ap).to(torch.bfloat16)
    a = torch.tensor(0.37, device=card)
    got = fuse.cg_update(xs, ys, ps, ap16, a, -a, 128, layouts=lays)
    want = fuse.cg_update_plain(xs, ys, ps, ap16, a, -a, lays)
    wide = fuse.cg_update(xs, ys, ps, ap16.float(), a, -a, 128, layouts=lays)
    for k in range(3):
        assert _bits(got[k], wide[k])
    _close_field(lay.unpack(got[1]), lay.unpack(want[1]))
    _close_sum(got[2], want[2], lay.unpack(want[1]) ** 2)
    st = [torch.stack([t, t.flip(0)]) for t in (xs, ys, ps)]
    apb = torch.stack([ap16, ap16])
    m = torch.tensor([1.0, 0.0], device=card)
    bx, br, brr = fuse.cg_update_masked(*st, apb, a.repeat(2), -a.repeat(2), m, 128,
                                        layouts=lays)
    assert _bits(bx[0], got[0]) and _bits(br[0], got[1]) and _bits(brr[0], got[2])
    assert _bits(bx[1], st[0][1]) and _bits(br[1], st[1][1])
    with pytest.raises(ValueError, match="bfloat16|float32"):
        fuse.cg_update(xs, ys, ps, ap16.half(), a, -a, 128, layouts=lays)
    with pytest.raises(ValueError, match="float32"):
        fuse.cg_update(xs, ys, ps.double(), ap16, a, -a, 128, layouts=lays)
    # a bf16 p runs K3's policy instance (widened at load, fp32 out)
    got16 = fuse.cg_update(xs, ys, ps.to(torch.bfloat16), ap16, a, -a, 128, layouts=lays)
    assert got16[0].dtype == torch.float32
    w16 = fuse.cg_update(xs, ys, ps.to(torch.bfloat16).float(), ap16.float(), a, -a, 128,
                         layouts=lays)
    for k in range(3):
        assert _bits(got16[k], w16[k])


# -- E: K3's and K3L's policy instances (the flat chains under a DtypePolicy) -------

def _flat_lc_inputs(rng, card, V):
    mk = lambda c, s: _dev(rng, (c, V), card, scale=s)  # noqa: E731
    return dict(q=mk(5, 0.05), lapq=mk(5, 0.02), dq=mk(15, 0.02), h=mk(5, 0.01), w=mk(9, 0.01),
                adv=mk(5, 0.01))


LC_ARGS = dict(a0=0.01, gamma=3.0, kappa_m=0.01, kappa_s=0.01, xi=0.7)
LU_ARGS = dict(gamma_rot=0.3, xi=0.7, dt=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", POLICY_LAYOUTS)
@pytest.mark.parametrize("vvl", [128, 1024])
def test_cg_update_policy_instance(card, spec, vvl, rng):
    """E: K3's policy instance in each layout, on the vector path (vvl 128)
    and the one-thread-a-site path (1024): under bf16 storage x_new and
    r_new in bf16 within one bf16 ulp of the plain version and rr within
    the fp64 oracle bound of the fp32 r_new's squares; under the
    accumulate-only policy the fields bitwise the policy-free kernel's; the
    same bits run to run; bf16 inputs bitwise their fp32 sources under the
    policy; a split fold; mixed layouts bitwise SoA."""
    from repro_torch.core.plan import CudaPolicy

    lay = parse_layout(spec)
    V = 4 * 1024
    x, y, p, ap = (_dev(rng, (24, V), card) for _ in range(4))
    lays = {n: lay for n in ("x", "r", "p", "ap", "x_new", "r_new")}
    xs, ys, ps, aps = (lay.pack(t) for t in (x, y, p, ap))
    a = torch.tensor(0.37, device=card)
    pol = CudaPolicy(True, True)
    xn, rn, rr = fuse.cg_update(xs, ys, ps, aps, a, -a, vvl, layouts=lays, policy=pol)
    assert xn.dtype == rn.dtype == torch.bfloat16 and rr.dtype == torch.float32
    wx, wr, _ = fuse.cg_update_plain(xs, ys, ps, aps, a, -a, lays, policy=pol)
    _within_bf16_ulp(lay.unpack(xn), lay.unpack(wx))
    _within_bf16_ulp(lay.unpack(rn), lay.unpack(wr))
    r32 = torch.addcmul(K.bf16_round(y), -a, K.bf16_round(ap))
    _oracle_sum(rr, r32 * r32)
    again = fuse.cg_update(xs, ys, ps, aps, a, -a, vvl, layouts=lays, policy=pol)
    assert _bits16(again[0], xn) and _bits16(again[1], rn) and _bits(again[2], rr)
    ins16 = [t.to(torch.bfloat16) for t in (xs, ys, ps, aps)]
    got16 = fuse.cg_update(*ins16, a, -a, vvl, layouts=lays, policy=pol)
    assert _bits16(got16[0], xn) and _bits16(got16[1], rn) and _bits(got16[2], rr)
    split = fuse.cg_update(xs, ys, ps, aps, a, -a, vvl, layouts=lays, policy=pol, rsplit=2)
    assert _bits16(split[1], rn)
    _oracle_sum(split[2], r32 * r32)
    acc = CudaPolicy(False, True)
    x0, r0, rr0 = fuse.cg_update(xs, ys, ps, aps, a, -a, vvl, layouts=lays)
    xa, ra, rra = fuse.cg_update(xs, ys, ps, aps, a, -a, vvl, layouts=lays, policy=acc)
    assert _bits(xa, x0) and _bits(ra, r0)
    r0c = lay.unpack(r0)
    _oracle_sum(rra, r0c * r0c)
    if spec != "soa":   # SoA inputs, outputs in the layout: the general path
        mixed = dict(lays, x=SOA, r=SOA, p=SOA, ap=SOA)
        mx = fuse.cg_update(x, y, p, ap, a, -a, vvl, layouts=mixed, policy=pol)
        assert _bits16(mx[0], xn) and _bits16(mx[1], rn)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", POLICY_LAYOUTS)
def test_ludwig_flat_policy_instances(card, spec, rng):
    """E: K3L's policy instances in each layout: under bf16 storage h, sigma
    and q_new in bf16 within one bf16 ulp of the plain versions; the same
    bits run to run; bf16 inputs bitwise their fp32 sources; the
    accumulate-only policy runs the policy-free kernels (no sums); a
    policy-free launch fed a bf16 h is bitwise the one fed h widened."""
    from repro_torch.core.plan import CudaPolicy

    lay = parse_layout(spec)
    V = int(np.prod(LB_LAT))
    t = {n: lay.pack(v) for n, v in _flat_lc_inputs(rng, card, V).items()}
    cs = {n: lay for n in ("q", "lapq", "dq", "h", "sigma")}
    lu = {n: lay for n in ("q", "h", "w", "adv", "q_new")}
    pol = CudaPolicy(True, True)
    h, sig = LK.chem_stress_cuda(t["q"], t["lapq"], t["dq"], **LC_ARGS, layouts=cs, policy=pol)
    qn = LK.lc_update_cuda(t["q"], t["h"], t["w"], t["adv"], **LU_ARGS, layouts=lu, policy=pol)
    wh, ws = LK.chem_stress_plain(t["q"], t["lapq"], t["dq"], **LC_ARGS, layouts=cs, policy=pol)
    wq = LK.lc_update_plain(t["q"], t["h"], t["w"], t["adv"], **LU_ARGS, layouts=lu, policy=pol)
    for got, want in ((h, wh), (sig, ws), (qn, wq)):
        assert got.dtype == torch.bfloat16
        _within_bf16_ulp(lay.unpack(got), lay.unpack(want))
    h2, s2 = LK.chem_stress_cuda(t["q"], t["lapq"], t["dq"], **LC_ARGS, layouts=cs, policy=pol)
    assert _bits16(h2, h) and _bits16(s2, sig)
    t16 = {n: v.to(torch.bfloat16) for n, v in t.items()}
    h16, s16 = LK.chem_stress_cuda(t16["q"], t16["lapq"], t16["dq"], **LC_ARGS, layouts=cs,
                                   policy=pol)
    q16 = LK.lc_update_cuda(t16["q"], t16["h"], t16["w"], t16["adv"], **LU_ARGS, layouts=lu,
                            policy=pol)
    assert _bits16(h16, h) and _bits16(s16, sig) and _bits16(q16, qn)
    acc = CudaPolicy(False, True)
    h0, s0 = LK.chem_stress_cuda(t["q"], t["lapq"], t["dq"], **LC_ARGS, layouts=cs)
    ha, sa = LK.chem_stress_cuda(t["q"], t["lapq"], t["dq"], **LC_ARGS, layouts=cs, policy=acc)
    assert _bits(ha, h0) and _bits(sa, s0)
    hb = t["h"].to(torch.bfloat16)
    qb = LK.lc_update_cuda(t["q"], hb, t["w"], t["adv"], **LU_ARGS, layouts=lu)
    qw = LK.lc_update_cuda(t["q"], hb.float(), t["w"], t["adv"], **LU_ARGS, layouts=lu)
    assert qb.dtype == torch.float32 and _bits(qb, qw)


@pytest.mark.cuda
def test_flat_policy_graphs_on_the_cuda_engine(card, rng):
    """The three graphs under a storage policy on the cuda engine: each
    launch runs its policy instance (its count moves) and gives the torch
    engine's launch under the policy within one bf16 ulp, rr within the
    oracle bound."""
    from repro_torch.core import LoweringPlan

    bf16 = DtypePolicy(storage="bfloat16", compute="float32", accumulate="float64")
    lat = LB_LAT
    V = int(np.prod(lat))
    cuda = TargetConfig("cuda", plan_policy=LoweringPlan("cuda", vvl=128, dtypes=bf16))
    torch_cfg = TargetConfig("torch", plan_policy=LoweringPlan("torch", dtypes=bf16))
    lcfg = LudwigConfig(lattice=lat)
    arrs = _flat_lc_inputs(rng, card, V)
    ins = {n: Field.from_canonical(n, arrs[n], lat) for n in arrs}
    for graph, names, outs, kern in (
            (LD.chem_stress_graph(lcfg), ("q", "lapq", "dq"), ("h", "sigma"), LK.CHEM_STRESS_POLICY),
            (LD.lc_update_graph(lcfg), ("q", "h", "w", "adv"), ("q_new",), LK.LC_UPDATE_POLICY)):
        n0 = kern.launches
        got = graph.launch({n: ins[n] for n in names}, config=cuda, outputs=outs)
        assert kern.launches == n0 + 1
        want = graph.launch({n: ins[n] for n in names}, config=torch_cfg, outputs=outs)
        for o in outs:
            assert got[o].dtype == torch.bfloat16
            _within_bf16_ulp(got[o].canonical(), want[o].canonical())
    f24 = {n: Field.from_canonical(n, _dev(rng, (24, V), card), lat) for n in ("x", "r", "p", "ap")}
    sc = {"alpha": 0.3, "neg_alpha": -0.3}
    n0 = fuse.CG_UPDATE_POLICY.launches
    got = CG.cg_update_graph(24).launch(f24, scalars=sc, config=cuda,
                                        outputs=("x_new", "r_new", "rr"))
    assert fuse.CG_UPDATE_POLICY.launches == n0 + 1
    want = CG.cg_update_graph(24).launch(f24, scalars=sc, config=torch_cfg,
                                         outputs=("x_new", "r_new", "rr"))
    for o in ("x_new", "r_new"):
        _within_bf16_ulp(got[o].canonical(), want[o].canonical())
    r32 = torch.addcmul(K.bf16_round(f24["r"].canonical()), torch.tensor(-0.3, device=card),
                        K.bf16_round(f24["ap"].canonical()))
    _oracle_sum(got["rr"], r32 * r32)


@pytest.mark.cuda
def test_compensated_sum_instance(card, rng):
    """D: K2's compensated instance within the oracle bound on the
    cancellation fixture (where the plain K2 is not), the adversarial
    fixtures and random fields; single, batched (rows bitwise the single
    launch) and run to run the same bits; max stays exact.  The fixtures
    are built on K2's tree (core/reduce.py's emulation): in x, 0.1875 at
    the sites K2 adds one at a time to +1e8 (virtual thread 0) or -1e8
    (thread 32) before the two cancel; cancel_field the same, block-aligned
    (whole chunks), at 3.52 x the oracle bound."""
    x = np.zeros((3, 256), np.float32)
    x[:, [1, 2, 4, 8, 16, 32, 64]] = x[:, [129, 130, 132, 136, 144, 160, 192]] = 0.1875
    x[:, 0], x[:, 128] = 1.0e8, -1.0e8
    adv = [np.resize(np.array([1.0, 1e8, 1.0, -1e8], np.float32), 4096),
           np.resize(np.array([1e7, 0.125, -1e7, 0.125], np.float32), 4096),
           (rng.normal(size=4096) * 1e4).astype(np.float32)]
    for arr, vvl in ((x, 32), (np.stack(adv), 128), (np.stack(adv), 32)):
        t = torch.from_numpy(arr).to(card)
        got = reduce.reduce_sites(t, "sum", vvl, compensated=True)
        _oracle_sum(got, t)
        assert _bits(got, reduce.reduce_sites(t, "sum", vvl, compensated=True))
        rows = reduce.reduce_sites_batched(torch.stack([t, t * 0.5]), "sum", vvl,
                                           compensated=True)
        assert _bits(rows[0], got)
    plain = reduce.reduce_sites(torch.from_numpy(x).to(card), "sum", 32)
    assert float((plain.double() - 2.625).abs().max()) > 0.1   # the plain fold loses the filler
    # block-aligned (two chunks): +-(2^26 + 8) in each chunk, and 3.9375
    # (under half its ulp) at the 15 sites a warp adds to it one at a time:
    # the plain K2 loses every filler, 3.52 x the oracle bound
    tb = reduce.cancel_field(2, 2 * reduce.CHUNK, device=card)
    _oracle_sum(reduce.reduce_sites(tb, "sum", 128, compensated=True), tb)
    with pytest.raises(AssertionError):
        _oracle_sum(reduce.reduce_sites(tb, "sum", 128), tb)
    f = Field.from_numpy("x", x, (4, 8, 8), device="cuda")
    acc = TargetConfig("cuda", device="cuda", vvl=32, dtypes=DtypePolicy(accumulate="float64"))
    _oracle_sum(reduce.target_sum(f, acc), f.canonical())
    assert torch.equal(reduce.target_max(f, acc), f.canonical().amax(dim=1))


@pytest.mark.cuda
def test_refined_drivers_on_card(card):
    """The refined solve, refined serving and the bf16 LB storage on the
    card: the refined solve within +-2 iterations and rel-L2 1e-4 of the
    torch engine's on the card and |Mx-b|/|b| < 1e-3, the policy kernels
    launched; solve_batched's slots bitwise their one-slot runs; Ludwig's
    float32 storage bitwise the policy-free step and bf16 within 1e-2 of
    it and within 1e-4 of the torch engine's bf16 steps."""
    from repro_torch.apps.milc import driver

    cfg = MilcConfig(lattice=(8, 8, 8, 8), kappa=0.12, tol=1e-10, max_iter=2000,
                     storage="bfloat16", target=TargetConfig("cuda", device="cuda"))
    u, b = init_problem(cfg, seed=0)
    for k in (K.WILSON_NORMAL_AP_MIXED, fuse.CG_UPDATE_AP16, reduce.REDUCE_FOLD_C):
        k.launches = 0
    res = solve(cfg, u, b)
    assert K.WILSON_NORMAL_AP_MIXED.launches and fuse.CG_UPDATE_AP16.launches
    assert reduce.REDUCE_FOLD_C.launches
    tres = solve(dataclasses.replace(cfg, target=TargetConfig("torch", device="cuda")), u, b)
    assert abs(res.iterations - tres.iterations) <= 2
    rel = torch.linalg.norm(res.x.data - tres.x.data) / torch.linalg.norm(tres.x.data)
    assert float(rel) < 1e-4 and residual_check(cfg, u, b, res.x) < 1e-3
    bs = _serve_sources(cfg, u, 3)
    bres = driver.solve_batched(cfg, u, bs)
    for i in range(2):
        one = driver.solve_batched(cfg, u, [bs[i]])
        assert torch.equal(bres.x.element(i).data, one.x.element(0).data)
        assert int(bres.iterations[i]) == int(one.iterations[0])
    lcfg = LudwigConfig(lattice=(16, 16, 16), target=TargetConfig("cuda", device="cuda"))
    states = {}
    for storage, tgt in (("", "cuda"), ("float32", "cuda"), ("bfloat16", "cuda"),
                         ("bfloat16", "torch")):
        c = LudwigConfig(lattice=lcfg.lattice, storage=storage,
                         target=TargetConfig(tgt, device="cuda"))
        s = init_state(c, seed=0)
        for _ in range(3):
            s = step(s, c)
        states[storage, tgt] = s
    ref = states["", "cuda"]
    for f in ("dist", "q"):
        assert torch.equal(getattr(states["float32", "cuda"], f).data, getattr(ref, f).data)
        got, r = getattr(states["bfloat16", "cuda"], f).data, getattr(ref, f).data
        assert float(torch.linalg.norm(got - r) / torch.linalg.norm(r)) < 1e-2
        t = getattr(states["bfloat16", "torch"], f).data
        assert float(torch.linalg.norm(got - t) / torch.linalg.norm(t)) < 1e-4


# -- K2 and K1 redesigned for Hopper: the kernels against the tree emulation and
# the plain versions, at tails, in every layout class, misaligned ------------------

K2_CASES = ([(spec, n) for spec in ("soa", "aos") for n in (1, 100, 4095, 4099, 65536)]
            + [("aosoa4", 4100), ("aosoa8", 4104), ("aosoa16", 65536), ("aosoa128", 65536),
               ("aosoa12", 4104)])   # aosoa12: no power of two, the strided class


def _misaligned(t):
    """A contiguous copy of t whose storage starts 4 bytes past a 16-byte
    boundary (a [1:] view of a larger buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("spec,nsites", K2_CASES)
def test_reduce_kernels_bitwise_their_tree(card, spec, nsites, rng):
    """K2 (plain, max, compensated; single and batched) bitwise
    core/reduce.py's tree emulation at tails and in every layout class
    (SoA and AoSoA >= 16: float4 loads; AoS, aosoa4/8: staged; aosoa12:
    strided), within SUM_RTOL (plain) or the oracle bound (compensated) of
    the fp64 sum, max exact, batch rows bitwise the single launch, the same
    bits run to run and on a misaligned field."""
    lay = parse_layout(spec)
    for ncomp in (24, 19):
        x = _dev(rng, (ncomp, nsites), card, scale=10.0)
        xl = lay.pack(x)
        cx = x.cpu()
        want, want_c = reduce.reduce_tree(cx), reduce.reduce_tree(cx, compensated=True)
        got = reduce.reduce_sites(xl, "sum", 128, layouts={"x": lay})
        assert _bits(got.cpu(), want), (spec, nsites, ncomp)
        got_c = reduce.reduce_sites(xl, "sum", 128, layouts={"x": lay}, compensated=True)
        assert _bits(got_c.cpu(), want_c), (spec, nsites, ncomp, "compensated")
        _close_sum(got, x.sum(dim=1), x)
        _oracle_sum(got_c, x)
        assert torch.equal(reduce.reduce_sites(xl, "max", 128, layouts={"x": lay}), x.amax(dim=1))
        assert _bits(reduce.reduce_sites(xl, "sum", 128, layouts={"x": lay}), got)
        assert _bits(reduce.reduce_sites(_misaligned(xl), "sum", 128, layouts={"x": lay}), got)
        stack = torch.stack([xl, xl * 0.5, xl])
        rows = reduce.reduce_sites_batched(stack, "sum", 128, layouts={"x": lay})
        rows_c = reduce.reduce_sites_batched(stack, "sum", 128, layouts={"x": lay},
                                             compensated=True)
        assert _bits(rows[0], got) and _bits(rows[2], got) and _bits(rows_c[0], got_c)
        assert _bits(rows[1].cpu(), reduce.reduce_tree(cx * 0.5))
        assert _bits(rows_c[1].cpu(), reduce.reduce_tree(cx * 0.5, compensated=True))


@pytest.mark.cuda
@pytest.mark.parametrize("nrows,ncomp", [(1, 24), (672, 24), (673, 24), (65536, 24),
                                         (131072, 19), (2048, 19), (5, 700)])
def test_reduce_fold_bitwise_its_tree(card, nrows, ncomp, rng):
    """K2's pass 2 alone on tables of the fused kernels' shapes and around
    the one-launch limit: bitwise fold_tree (plain, compensated; batched
    rows bitwise the single fold), its scratch the size core/reduce.py
    allocates (fold_scratch); a table of values refused as pairs."""
    p = _dev(rng, (nrows, ncomp), card)
    assert _bits(reduce.fold_partials(p, "sum").cpu(), reduce.fold_tree(p.cpu()))
    pairs = torch.stack([p, p * 2.0 ** -30], dim=-1)
    got_c = reduce.fold_partials(pairs, "sum", compensated=True)
    assert _bits(got_c.cpu(), reduce.fold_tree(pairs.cpu(), compensated=True))
    assert torch.equal(reduce.fold_partials(p, "max"), p.amax(dim=0))
    rows = reduce.fold_partials_batched(torch.stack([p * 2, p]), "sum")
    assert _bits(rows[1], reduce.fold_partials(p, "sum"))
    rows_c = reduce.fold_partials_batched(torch.stack([pairs * 2, pairs]), "sum", compensated=True)
    assert _bits(rows_c[1], got_c)
    from repro_torch import _cuda
    assert _cuda.library().rt_reduce_fold_scratch(nrows, ncomp) == reduce.fold_scratch(nrows,
                                                                                       ncomp)
    with pytest.raises(ValueError, match="expected"):   # values, not pairs
        reduce.fold_partials(p, "sum", compensated=True)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa4", "aosoa16", "aosoa12"])
def test_site_kernels_bitwise_plain_odd_and_misaligned(card, spec, rng):
    """K1 (g5 at flip_from 0, 12, 23 and ncomp; the product, single and
    batched; axpy) bitwise its plain version (axpy: bitwise its SoA launch,
    one FMA an element, and within FIELD_RTOL of the plain x * a + y) in
    the layout, at sizes that are not a multiple of 4 where the layout
    allows them, with 12 * 1001 and 23 * 1001 splitting a float4, and on
    misaligned fields (the general path)."""
    lay = parse_layout(spec)
    sizes = [(24, 1001), (19, 1001)] if lay.kind.value != "aosoa" else [(24, 1008), (19, 1008)]
    for ncomp, nsites in sizes:
        x, y = (_dev(rng, (ncomp, nsites), card) for _ in range(2))
        xl, yl = lay.pack(x), lay.pack(y)
        L1, L2 = {"x": lay}, {"x": lay, "y": lay}
        for flip in (0, 12, 23, ncomp) if ncomp == 24 else (0, 12, ncomp):
            want = target.g5_plain(xl, flip, layouts=L1)
            assert _bits(target.site_g5(xl, flip, layouts=L1), want), (spec, ncomp, flip)
            assert _bits(target.site_g5(_misaligned(xl), flip, layouts=L1), want)
        want = target.mul_plain(xl, yl, L2)
        assert _bits(target.site_mul(xl, yl, layouts=L2), want)
        assert _bits(target.site_mul(_misaligned(xl), yl, layouts=L2), want)
        ax = target.site_axpy(0.75, xl, yl, layouts=L2)
        assert _same(ax, lay, target.site_axpy(0.75, x, y), "axpy") is None
        assert _bits(target.site_axpy(0.75, xl, _misaligned(yl), layouts=L2), ax)
        _close_field(lay.unpack(ax), x * 0.75 + y)
        xs = torch.stack([xl, yl, xl * 2])
        want_b = target.mul_plain(xs, yl, L2, batch=3)
        assert _bits(target.site_mul(xs, yl, layouts=L2, batch=3), want_b)
        assert _bits(target.site_mul(xs, torch.stack([yl] * 3), layouts=L2, batch=3), want_b)



# -- K2's max propagates NaN; K3 and K5 redesigned for Hopper -----------------------

def _same_nan_bits(got, want):
    """NaN exactly where want has NaN (its payload is not pinned), every
    other value bitwise."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), (got, want)
    assert _bits(got[~nan], want[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa16", "aosoa12"])
def test_reduce_max_propagates_nan(card, spec, rng):
    """K2 and K2B max on fields with NaN sites, in SoA and AoSoA 16 (direct
    block, float4 loads), AoS (staged block) and aosoa12 (the run-time
    layout class): NaN in every component the torch engine's amax (and the
    tree emulation) makes NaN, an all-NaN component NaN (fmaxf gave -inf),
    every other component bitwise; the fused kernels' max fold too."""
    lay = parse_layout(spec)
    for nsites in (4176, 12 * 4096):   # tails; multiples of 16 and 12 (the layouts' SAL)
        x = _dev(rng, (19, nsites), card, scale=10.0)
        x[0, 5] = float("nan")
        x[3, nsites - 1] = float("nan")
        x[7, 4096 + 17 if nsites > 4096 + 17 else 9] = float("nan")
        x[11] = float("nan")
        want = x.amax(dim=1)
        assert torch.isnan(want[[0, 3, 7, 11]]).all() and not torch.isnan(want[1])
        got = reduce.reduce_sites(lay.pack(x), "max", 128, layouts={"x": lay})
        _same_nan_bits(got, want)
        _same_nan_bits(got, reduce.reduce_tree(x.cpu(), "max"))
        stack = torch.stack([lay.pack(x), lay.pack(x.flip(0)), lay.pack(x.abs())])
        rows = reduce.reduce_sites_batched(stack, "max", 128, layouts={"x": lay})
        for b, c in enumerate((x, x.flip(0), x.abs())):
            _same_nan_bits(rows[b], c.amax(dim=1))
        _same_nan_bits(reduce.fold_partials(x.T.contiguous(), "max"), want)
        _same_nan_bits(reduce.fold_partials_batched(torch.stack([x.T, x.T * 2]).contiguous(),
                                                    "max")[1], (x * 2).amax(dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa4", "aosoa16"])
def test_cg_xpay_vector_tails_bitwise(card, spec, rng):
    """cg_xpay's vector path (float4s, 32-bit offsets, a scalar tail where
    the field's size is not a multiple of 4) bitwise the one-element-a-thread
    path (a misaligned operand takes it) and within tolerance of the plain
    version; K3B's slots, stacked and shared, at odd and offset slot bases,
    bitwise the single launch on their slot, frozen slots bitwise y."""
    lay = parse_layout(spec)
    sizes = [(19, 1001), (24, 1001), (3, 5)] if lay.kind.value != "aosoa" else [(19, 1008),
                                                                                (24, 1008)]
    for ncomp, nsites in sizes:
        x, y = (_dev(rng, (ncomp, nsites), card) for _ in range(2))
        xl, yl = lay.pack(x), lay.pack(y)
        a = torch.tensor(0.37, device=card)
        L2 = {"x": lay, "y": lay}
        got = fuse.cg_xpay(xl, yl, a, 128, layouts=L2)
        assert _bits(got, fuse.cg_xpay(_misaligned(xl), yl, a, 128, layouts=L2))
        assert _bits(got, fuse.cg_xpay(xl, _misaligned(yl), a, 128, layouts=L2))
        _close_field(lay.unpack(got), y + 0.37 * x)
        xs, ys = torch.stack([xl, yl, xl * 2]), torch.stack([yl, xl, yl])
        av = torch.tensor([0.37, -1.25, 2.0], device=card)
        m = torch.tensor([1.0, 0.0, 1.0], device=card)
        out = fuse.cg_xpay_masked(xs, ys, av, m, 128, layouts=L2)
        shared = fuse.cg_xpay_masked(xs, yl, av, m, 128, layouts=L2)
        for b in (0, 2):
            assert _bits(out[b], fuse.cg_xpay(xs[b], ys[b], av[b], 128, layouts=L2))
            assert _bits(shared[b], fuse.cg_xpay(xs[b], yl, av[b], 128, layouts=L2))
        assert _bits(out[1], ys[1]) and _bits(shared[1], yl)


@pytest.mark.cuda
@pytest.mark.parametrize("vvl", [32, 64, 128, 256])
@pytest.mark.parametrize("spec", ["aos", "aosoa2", "aosoa4", "aosoa8", "aosoa16", "aosoa32"])
def test_cg_update_vector_path_bitwise_soa(card, spec, vvl, rng):
    """cg_update's vector path (float4s over a block's contiguous elements,
    r_new^2 through shared memory into the one-site-a-thread fold) in AoS
    and AoSoA at vvl 32..256 and 2016 sites (a partial last block): x_new,
    r_new and rr bitwise the SoA launch, which is bitwise the general path
    (a misaligned operand takes it); the masked and bf16-ap instances the
    same, every slot bitwise its single launch."""
    lay = parse_layout(spec)
    V = 2016
    x, r, p, ap = (_dev(rng, (24, V), card) for _ in range(4))
    a = torch.tensor(0.37, device=card)
    soa = fuse.cg_update(x, r, p, ap, a, -a, vvl)
    gen = fuse.cg_update(_misaligned(x), r, p, ap, a, -a, vvl)
    for k in range(3):
        assert _bits(soa[k], gen[k])
    lays = {n: lay for n in ("x", "r", "p", "ap")}
    xl, rl, pl, apl = (lay.pack(t) for t in (x, r, p, ap))
    got = fuse.cg_update(xl, rl, pl, apl, a, -a, vvl, layouts=lays)
    _same(got[0], lay, soa[0], "x_new")
    _same(got[1], lay, soa[1], "r_new")
    assert _bits(got[2], soa[2])
    plain = fuse.cg_update_plain(x, r, p, ap, a, -a)
    _close_field(soa[1], plain[1])
    _close_sum(soa[2], plain[2], plain[1] ** 2)
    ap16 = apl.to(torch.bfloat16)
    g16 = fuse.cg_update(xl, rl, pl, ap16, a, -a, vvl, layouts=lays)
    w16 = fuse.cg_update(x, r, p, lay.unpack(ap16).float().contiguous(), a, -a, vvl)
    _same(g16[1], lay, w16[1], "r_new (bf16 ap)")
    assert _bits(g16[2], w16[2])
    st = [torch.stack([t, t.flip(0)]) for t in (xl, rl, pl)]
    m = torch.tensor([1.0, 0.0], device=card)
    for apb in (torch.stack([apl, apl]), torch.stack([ap16, ap16])):
        bx, br, brr = fuse.cg_update_masked(*st, apb, a.repeat(2), -a.repeat(2), m, vvl,
                                            layouts=lays)
        one = fuse.cg_update(xl, rl, pl, apb[0], a, -a, vvl, layouts=lays)
        assert _bits(bx[0], one[0]) and _bits(br[0], one[1]) and _bits(brr[0], one[2])
        assert _bits(bx[1], st[0][1]) and _bits(br[1], st[1][1])
        zero = torch.zeros((), device=card)   # r + 0 ap: the frozen slot's r, squared
        frozen = fuse.cg_update(st[0][1], st[1][1], pl, apb[1], zero, zero, vvl, layouts=lays)
        assert _bits(brr[1], frozen[2])
    shared = fuse.cg_update_masked(st[0], st[1], pl, apl, a.repeat(2), -a.repeat(2),
                                   torch.ones(2, device=card), vvl, layouts=lays)
    assert _bits(shared[1][0], got[1]) and _bits(shared[2][0], got[2])


def _normal_partials(p, u, lat, vvl, batch=None):
    """K5's two launches with their partial table returned: (t, ap,
    partials (batch, ceil(V / vvl), 24))."""
    V = int(np.prod(lat))
    nb = batch or 1
    t = torch.empty((nb, 24, V), device=p.device)
    ap = torch.empty_like(p)
    parts = torch.empty((nb, -(-V // vvl), 24), device=p.device)
    K.WILSON_NORMAL_T_B.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(), 0.12, *lat,
                               nb, 0, 0, vvl)
    K.WILSON_NORMAL_AP_B.launch(p.device, p.data_ptr(), t.data_ptr(), u.data_ptr(),
                                ap.data_ptr(), parts.data_ptr(), 0.12, *lat, nb, 0, 0, 0, vvl)
    return t, ap, parts


@pytest.mark.cuda
@pytest.mark.parametrize("lat,vvl", [((16, 4, 4, 8), 32), ((20, 4, 4, 8), 32),
                                     ((20, 4, 4, 8), 128), ((4, 4, 6, 8), 32),
                                     ((4, 4, 6, 8), 64), ((3, 4, 4, 8), 128)],
                         ids=["x16", "x20", "x20-plane", "x4-brick", "x4-linear", "x3"])
def test_wilson_normal_block_order(card, lat, vvl, rng):
    """K5 in its block order at lattices whose X is (16) and is not (20, 4,
    3) a multiple of the brick, and at (4, 4, 6, 8) vvl 64, where vvl does
    not divide an x-plane (linear order): ap within tolerance of the plain
    version and bitwise the same at every vvl (a site's arithmetic does not
    depend on the order); each partial row the sum of p * ap over its chunk
    (within tolerance: the row sits at its chunk's index); K5B over 1..5
    slots each bitwise its one-slot launch; soa, aos and aosoa16 bitwise
    SoA; the policy instance's slots bitwise its one-slot launch."""
    from repro_torch.core.plan import CudaPolicy

    V = int(np.prod(lat))
    u = torch.from_numpy(fields.random_su3_gauge(lat, seed=2).reshape(72, -1)).to(card)
    p = _dev(rng, (24, V), card)
    ap, pap = K.wilson_normal_cuda(p, u, 0.12, lat, vvl)
    want_ap, want_pap = K.wilson_normal_plain(p, u, 0.12, lat)
    _close_field(ap, want_ap)
    _close_sum(pap, want_pap, p * want_ap)
    assert _bits(ap, K.wilson_normal_cuda(p, u, 0.12, lat, 32)[0])
    t, ap2, parts = _normal_partials(p, u, lat, vvl)
    assert _bits(ap2, ap) and _bits(reduce.fold_partials(parts[0], "sum"), pap)
    prod = (p * want_ap).reshape(24, -1, vvl) if V % vvl == 0 else None
    if prod is not None:
        _close_sum(parts[0], prod.sum(dim=2).T, prod.permute(1, 0, 2))
    for nb in range(1, 6):
        pb = torch.stack([p * (1 + 0.25 * k) for k in range(nb)])
        apb, papb = K.wilson_normal_cuda(pb, u, 0.12, lat, vvl, batched=True)
        for b in range(nb):
            one = K.wilson_normal_cuda(pb[b], u, 0.12, lat, vvl)
            assert _bits(apb[b], one[0]) and _bits(papb[b], one[1]), (nb, b)
    for spec in ("aos", "aosoa16"):
        lay = parse_layout(spec)
        if V % lay.sal or vvl % lay.sal:
            continue
        lays = {"p": lay, "u": lay, "ap": lay}
        al, sl = K.wilson_normal_cuda(lay.pack(p), lay.pack(u), 0.12, lat, vvl, layouts=lays)
        _same(al, lay, ap, f"wilson_normal ap ({spec})")
        assert _bits(sl, pap)
    pol = CudaPolicy(True, True)
    u16 = K.bf16_pack_cuda(u)
    assert _bits(u16.float(), K.bf16_round(u))
    ap16, pap16 = K.wilson_normal_cuda(p, u16, 0.12, lat, vvl, policy=pol)
    _within_bf16_ulp(ap16, K.wilson_normal_plain(p, u, 0.12, lat, policy=pol)[0])
    with pytest.raises(ValueError, match="bf16 copy of u"):
        K.wilson_normal_cuda(p, u, 0.12, lat, vvl, policy=pol)   # an fp32 u under bf16 storage
    pb = torch.stack([p, p.flip(0), p * 0.5])
    apb, papb = K.wilson_normal_cuda(pb, u16, 0.12, lat, vvl, batched=True, policy=pol)
    for b in range(3):
        one = K.wilson_normal_cuda(pb[b], u16, 0.12, lat, vvl, policy=pol)
        assert _bits(apb[b].float(), one[0].float()) and _bits(papb[b], one[1])
    with pytest.raises(ValueError, match="float32"):
        K.wilson_normal_cuda(p, u16, 0.12, lat, vvl)        # a bf16 u without the policy


@pytest.mark.cuda
def test_wilson_normal_refuses_what_it_does_not_take(card):
    """K5's whole-warp blocks: a vvl that is not a multiple of 32 raises
    before any launch."""
    p = torch.zeros((24, 512), device=card)
    u = torch.zeros((72, 512), device=card)
    with pytest.raises(ValueError, match="whole number of warps"):
        K.wilson_normal_cuda(p, u, 0.12, (4, 4, 4, 8), 48)


@pytest.mark.cuda
def test_wilson_normal_wide_lattice(card, rng):
    """K5, K5B and the policy instance on a lattice with 72 V >= 2^31, where
    a field's offsets take the 64-bit instantiation (one slot a thread).
    The fields repeat with period 4 in x, so t, ap and every chunk's
    partial row are bitwise those of the 32-bit launch on the (4, 64, 64,
    32) lattice they repeat; X = 228 is not a multiple of the brick.  Each
    K5B slot is bitwise its one-slot launch."""
    from repro_torch.core.plan import CudaPolicy

    small, reps, vvl = (4, 64, 64, 32), 57, 128
    lat = (small[0] * reps,) + small[1:]
    assert 72 * int(np.prod(lat)) >= 2 ** 31 > 72 * int(np.prod(small))
    V = int(np.prod(small))
    u = _dev(rng, (72, V), card) * 0.2     # bitwise checks need no SU(3) field
    p = _dev(rng, (24, V), card)
    t_s, ap_s, parts_s = _normal_partials(p, u, small, vvl)
    _close_field(ap_s, K.wilson_normal_plain(p, u, 0.12, small)[0])
    uw, pw = u.repeat(1, reps), p.repeat(1, reps)
    t_w, ap_w, parts_w = _normal_partials(pw, uw, lat, vvl)
    assert _bits(t_w, t_s.repeat(1, 1, reps)) and _bits(ap_w, ap_s.repeat(1, reps))
    assert _bits(parts_w, parts_s.repeat(1, reps, 1))
    del t_w, parts_w
    one = K.wilson_normal_cuda(pw, uw, 0.12, lat, vvl)
    assert _bits(one[0], ap_w)
    del ap_w
    pb = torch.stack([pw, -0.5 * pw])
    apb, papb = K.wilson_normal_cuda(pb, uw, 0.12, lat, vvl, batched=True)
    assert _bits(apb[0], one[0]) and _bits(papb[0], one[1])
    del one
    one = K.wilson_normal_cuda(pb[1], uw, 0.12, lat, vvl)
    assert _bits(apb[1], one[0]) and _bits(papb[1], one[1])
    del apb, papb, one
    pol = CudaPolicy(True, True)
    u16, uw16 = K.bf16_pack_cuda(u), K.bf16_pack_cuda(uw)
    del uw
    ap16 = K.wilson_normal_cuda(p, u16, 0.12, small, vvl, policy=pol)[0]
    apb, papb = K.wilson_normal_cuda(pb, uw16, 0.12, lat, vvl, batched=True, policy=pol)
    one = K.wilson_normal_cuda(pw, uw16, 0.12, lat, vvl, policy=pol)
    assert _bits(one[0], ap16.repeat(1, reps)) and _bits(apb[0], one[0])
    assert _bits(papb[0], one[1])
    del apb, papb, one, pb, pw, uw16
    torch.cuda.empty_cache()

# -- K4's block order and AoS loads; K5L's staged loads -------------------------------

DSLASH_LATTICES = [(4, 6, 8, 32), (6, 10, 4, 12), (2, 4, 4, 8), (20, 2, 4, 4), (6, 10, 6, 12),
                   (3, 5, 7, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("lat", DSLASH_LATTICES, ids=lambda t: "x".join(map(str, t)))
def test_dslash_in_every_layout_equals_soa(card, lat, rng):
    """K4 in its brick order (thin last bricks at X = 6, 20, 3; linear where
    vvl does not divide Y Z T) within tolerance of the plain version and
    bitwise the same at vvl 32, 64, 96 and 128; in aos and aosoa2, 4, 8, 16
    (warp-staged runs where T is 32 and vvl at most 128, else loads through
    INDEX a thread), in aos with psi one float off 16-byte alignment, in
    aosoa6 and in mixed layouts bitwise the SoA launch."""
    V = int(np.prod(lat))
    u = torch.from_numpy(fields.random_su3_gauge(lat, seed=3).reshape(72, -1)).to(card)
    psi = _dev(rng, (24, V), card)
    want = K.dslash_cuda(psi, u, lat, 32)
    _close_field(want, K.dslash_plain(psi, u, lat))
    for vvl in (64, 96, 128):
        assert _bits(K.dslash_cuda(psi, u, lat, vvl), want), vvl
    for spec in ("aos", "aosoa2", "aosoa4", "aosoa8", "aosoa16", "aosoa6"):
        lay = parse_layout(spec)
        if V % lay.sal:
            continue
        pl, ul = lay.pack(psi), lay.pack(u)
        for vvl in (32, 128, 256):
            _same(K.dslash_cuda(pl, ul, lat, vvl, layouts={"psi": lay, "u": lay}), lay, want,
                  f"dslash ({spec}, vvl {vvl})")
    aos = parse_layout("aos")
    buf = torch.empty(24 * V + 1, device=card)
    off = buf[1:].view(V, 24)      # 4 bytes past a 16-byte boundary
    off.copy_(aos.pack(psi))
    _same(K.dslash_cuda(off, aos.pack(u), lat, 32, layouts={"psi": aos, "u": aos}), aos, want,
          "dslash (aos, misaligned psi)")
    a8 = parse_layout("aosoa8")
    if V % 8 == 0:
        L = {"psi": aos, "u": SOA, "out": a8}
        _same(K.dslash_cuda(aos.pack(psi), u, lat, 32, layouts=L), a8, want, "dslash mixed")


@pytest.mark.cuda
def test_dslash_wide_lattice(card, rng):
    """K4 on a lattice with 72 V >= 2^31 (its 64-bit instantiation): psi and
    u repeat with period 4 in x, so D psi is bitwise the repeat of the
    32-bit launch on the (4, 64, 64, 32) lattice they repeat; X = 228 is not
    a multiple of the brick."""
    small, reps = (4, 64, 64, 32), 57
    lat = (small[0] * reps,) + small[1:]
    assert 72 * int(np.prod(lat)) >= 2 ** 31 > 72 * int(np.prod(small))
    V = int(np.prod(small))
    u = _dev(rng, (72, V), card) * 0.2     # bitwise checks need no SU(3) field
    psi = _dev(rng, (24, V), card)
    want = K.dslash_cuda(psi, u, small, 128)
    _close_field(want, K.dslash_plain(psi, u, small))
    uw, pw = u.repeat(1, reps), psi.repeat(1, reps)
    got = K.dslash_cuda(pw, uw, lat, 128)
    assert _bits(got, want.repeat(1, reps))


LB_STAGE_LAT = (8, 6, 10)   # 480 sites: a partial last chunk at vvl 64, 128 and 256


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["aos", "aosoa4", "aosoa8", "aosoa16", "aosoa32", "aosoa6"])
def test_lb_step_staged_loads_equal_soa(card, spec, rng):
    """K5L (ludwig_lb_step, lb_collide_propagate and the policy instance) at
    vvl 32, 64, 128 and 256 in each layout bitwise its SoA launch at vvl
    128 (staged chunks, site-by-site partial chunks and, for aosoa6 and
    where the SAL does not divide vvl, site-by-site launches), and dist2
    bitwise K8(K7(f)) in that layout."""
    lay = parse_layout(spec)
    lat = LB_STAGE_LAT
    V = int(np.prod(lat))
    w = torch.tensor([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12)[:, None]
    dist = (w * (1 + 0.1 * torch.from_numpy(rng.normal(size=(19, V)).astype(np.float32)))).to(card)
    force = _dev(rng, (3, V), card, scale=1e-3)
    want = K8.lb_step_cuda(dist, force, 0.8, lat, 128)
    want16 = K8.lb_step_cuda(dist, force, 0.8, lat, 128, bf16=True)
    L = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
    d, f = lay.pack(dist), lay.pack(force)
    for vvl in (32, 64, 128, 256):
        d2, u = K8.lb_step_cuda(d, f, 0.8, lat, vvl, layouts=L)
        _same(d2, lay, want[0], f"lb_step dist2 vvl {vvl}")
        _same(u, lay, want[1], f"lb_step u vvl {vvl}")
        only2, none = K8.lb_step_cuda(d, f, 0.8, lat, vvl, with_u=False, layouts=L)
        assert none is None and torch.equal(only2, d2)
        b2, bu = K8.lb_step_cuda(d, f, 0.8, lat, vvl, layouts=L, bf16=True)
        assert _bits(lay.unpack(b2).float(), want16[0].float())
        assert _bits(lay.unpack(bu).float(), want16[1].float())
        assert torch.equal(K8.lb_step_cuda(dist, force, 0.8, lat, vvl)[0], want[0])
    c = K7.collide_cuda(d, f, 0.8, 128, layouts={"dist": lay, "force": lay, "out": lay})
    assert torch.equal(K8.propagate_cuda(c, lat, 128, layouts={"dist": lay}), d2)


# -- K7's staged chunks, K8's staged tiles and the collision's pinned roundings --------

K7_LAYOUTS = ["aos", "aosoa2", "aosoa4", "aosoa8", "aosoa16", "aosoa32", "aosoa6"]


def _lb_dist(rng, card, V):
    w = torch.tensor([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12)[:, None]
    return (w * (1 + 0.1 * torch.from_numpy(rng.normal(size=(19, V)).astype(np.float32)))).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", K7_LAYOUTS)
def test_k7_in_every_layout_bitwise_soa_and_plain(card, spec, rng):
    """K7 at vvl 32, 64, 128 and 256 on LB_STAGE_LAT (a partial last chunk
    at 64, 128 and 256): staged chunks where the SAL divides vvl, site by
    site elsewhere, each launch bitwise the SoA launch at vvl 128, which is
    bitwise collide_plain on the card (the collision's pinned roundings);
    force in SoA beside dist in the layout (mixed: site by site) and dist
    one float off 16-byte alignment (site by site) bitwise the same."""
    lay = parse_layout(spec)
    lat = LB_STAGE_LAT
    V = int(np.prod(lat))
    dist, force = _lb_dist(rng, card, V), _dev(rng, (3, V), card, scale=1e-3)
    want = K7.collide_cuda(dist, force, 0.8, 128)
    assert _bits(want, K7.collide_plain(dist, force, 0.8))
    d, f = lay.pack(dist), lay.pack(force)
    L = {"dist": lay, "force": lay, "out": lay}
    for vvl in (32, 64, 128, 256):
        _same(K7.collide_cuda(d, f, 0.8, vvl, layouts=L), lay, want, f"collide vvl {vvl}")
        assert _bits(K7.collide_cuda(dist, force, 0.8, vvl), want), vvl
    _same(K7.collide_cuda(d, force, 0.8, 64, layouts={"dist": lay, "force": SOA, "out": lay}),
          lay, want, "collide, force in SoA")
    _same(K7.collide_cuda(_misaligned(d), f, 0.8, 128, layouts=L), lay, want,
          "collide, dist misaligned")
    assert _bits(K7.collide_plain(d, f, 0.8, L), K7.collide_cuda(d, f, 0.8, 128, layouts=L))


# K8's tiles: extents 1, 2 and 3 on x, a last x-slab that is partial (X 9,
# 5), whole tiles on y and z (staged) or not (Y 6, Z 40: site by site)
K8_LATTICES = [(1, 4, 32), (2, 8, 64), (3, 4, 32), (9, 4, 32), (5, 8, 96), (16, 12, 64),
               (4, 6, 32), (3, 4, 40), (2, 1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("lat", K8_LATTICES, ids=lambda t: "x".join(map(str, t)))
def test_k8_in_every_layout_bitwise_plain(card, lat, rng):
    """K8 in soa and every layout of K7_LAYOUTS that tiles the lattice, at
    vvl 32, 64, 128 and 256, bitwise propagate_plain; in aos also with dist
    one float off 16-byte alignment, and in mixed layouts."""
    V = int(np.prod(lat))
    dist = _lb_dist(rng, card, V)
    want = K8.propagate_plain(dist, lat)
    for spec in ["soa"] + K7_LAYOUTS:
        lay = parse_layout(spec)
        if not lay.fits(V):
            continue
        d = lay.pack(dist)
        for vvl in (32, 64, 128, 256):
            _same(K8.propagate_cuda(d, lat, vvl, layouts={"dist": lay}), lay, want,
                  f"propagate vvl {vvl}")
        assert _bits(K8.propagate_cuda(d, lat, 128, layouts={"dist": lay}),
                     K8.propagate_plain(d, lat, {"dist": lay}))
    aos = parse_layout("aos")
    _same(K8.propagate_cuda(_misaligned(aos.pack(dist)), lat, 128, layouts={"dist": aos}), aos,
          want, "propagate, dist misaligned")
    _same(K8.propagate_cuda(aos.pack(dist), lat, 128, layouts={"dist": aos, "out": SOA}), SOA,
          want, "propagate, aos to soa")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa4", "aosoa16"])
def test_pinned_collision_bitwise_plain(card, spec, rng):
    """With the collision's roundings pinned (csrc/d3q19.cuh), K5L's dist2
    and u, its policy instance's bf16 dist2 and u, and K9's and its policy
    instance's dist2 and u are bitwise their plain versions on the card."""
    lay = parse_layout(spec)
    lat = (8, 8, 16)
    V = int(np.prod(lat))
    dist, force = _lb_dist(rng, card, V), _dev(rng, (3, V), card, scale=1e-3)
    d, f = lay.pack(dist), lay.pack(force)
    L = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
    for bf16 in (False, True):
        got = K8.lb_step_cuda(d, f, 0.8, lat, 128, layouts=L, bf16=bf16)
        want = K8.lb_step_plain(d, f, 0.8, lat, layouts=L, bf16=bf16)
        for g, w in zip(got, want):
            assert _bits(g.float(), w.float()), (spec, bf16)
        for tile in ((1, 4, 8), (8, 8, 16)):
            got = K8.lb_step_tiled_cuda(d, f, 0.8, lat, tile, layouts=L, bf16=bf16)
            want = K8.lb_step_tiled_plain(d, f, 0.8, lat, tile, layouts=L, bf16=bf16)
            for g, w in zip(got, want):
                assert _bits(g.float(), w.float()), (spec, bf16, tile)


# -- split reductions (K2S), K2's int32 and bf16 instances, the block view ----------

def _bits16(a, b):
    """Bitwise equality of bf16 tensors."""
    return torch.equal(a.contiguous().view(torch.int16), b.contiguous().view(torch.int16))


def _bf16_ulp(v):
    """The spacing of bf16 numbers at each (finite, normal) value of v, in fp64."""
    e = torch.floor(torch.log2(v.double().abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("nrows", [1, 3, 64, 1345, 4096])
def test_k2s_bitwise_fold_tree_split(card, nrows, rng):
    """K2S (single, batched, compensated) bitwise core/reduce.py's
    fold_tree_split run on the card, at rsplit 1, 2, 4 and 16: empty
    segments (R 1 and 3), segments on either side of the one-launch limit
    (R 1345 at rsplit 2: 672 and 673 rows), segments that take level 1 (R
    4096); rsplit 1 bitwise the unsplit fold; its scratch the size
    core/reduce.py allocates."""
    from repro_torch import _cuda

    p = _dev(rng, (nrows, 24), card, scale=10.0)
    pairs = torch.stack([p, p * 2.0 ** -30], dim=-1)
    ip = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(nrows, 24),
                                       dtype=np.int64).astype(np.int32)).to(card)
    for rs in (1, 2, 4, 16):
        for op in ("sum", "max"):
            got = reduce.fold_partials(p, op, rsplit=rs)
            assert _bits(got, reduce.fold_tree_split(p, op, rsplit=rs)), (rs, op)
            rows = reduce.fold_partials_batched(torch.stack([p * 2, p]), op, rsplit=rs)
            assert _bits(rows[1], got), (rs, op)
            gi = reduce.fold_partials(ip, op, rsplit=rs)
            assert gi.dtype == torch.int32
            assert torch.equal(gi, reduce.fold_tree_split(ip, op, rsplit=rs)), (rs, op)
            assert torch.equal(gi, ip.sum(dim=0, dtype=torch.int32) if op == "sum"
                               else ip.amax(dim=0)), (rs, op)
        got_c = reduce.fold_partials(pairs, "sum", compensated=True, rsplit=rs)
        assert _bits(got_c, reduce.fold_tree_split(pairs, "sum", True, rsplit=rs)), rs
        rows_c = reduce.fold_partials_batched(torch.stack([pairs, pairs * 2]), "sum",
                                              compensated=True, rsplit=rs)
        assert _bits(rows_c[0], got_c), rs
        assert _cuda.library().rt_reduce_fold_split_scratch(nrows, 24, rs) == \
            reduce.fold_scratch(nrows, 24, rs)
        if rs == 1:
            assert _bits(got_c, reduce.fold_tree(pairs, compensated=True))
            assert _bits(reduce.fold_partials(p, "sum"), reduce.fold_tree(p))
    launches = reduce.REDUCE_FOLD_S.launches
    reduce.fold_partials(p, "sum", rsplit=4)
    assert reduce.REDUCE_FOLD_S.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa4", "aosoa16", "aosoa12"])
def test_k2_int32_and_bf16_instances(card, spec, rng):
    """K2's int32 instance (sum wrapping past 2^31, max) bitwise torch's sum
    and amax, and its bf16 instance (sum, max) bitwise reduce_tree on the
    widened field rounded once and within one bf16 ulp of the fp64 sum
    rounded, in the layout, at a tail, misaligned, batched, and under
    rsplit 4 bitwise the unsplit result."""
    lay = parse_layout(spec)
    for ncomp, nsites in ((24, 8208), (19, 4128)):
        xi = torch.from_numpy(rng.integers(-2**24, 2**24, size=(ncomp, nsites),
                                           dtype=np.int64).astype(np.int32)).to(card)
        xi[3] = 2**30 + 7   # its sum wraps
        li = lay.pack(xi)
        L = {"x": lay}
        want = xi.sum(dim=1, dtype=torch.int32)
        assert int(want[3]) != (2**30 + 7) * nsites
        for op, w in (("sum", want), ("max", xi.amax(dim=1))):
            got = reduce.reduce_sites(li, op, layouts=L)
            assert got.dtype == torch.int32 and torch.equal(got, w), (spec, op)
            assert torch.equal(reduce.reduce_sites(li, op, layouts=L, rsplit=4), w)
            assert torch.equal(reduce.reduce_sites(_misaligned(li), op, layouts=L), w)
            rows = reduce.reduce_sites_batched(torch.stack([li, li]), op, layouts=L, rsplit=2)
            assert torch.equal(rows[1], w), (spec, op)
        xb = _dev(rng, (ncomp, nsites), card, scale=3.0, offset=1.0).to(torch.bfloat16)
        lb = lay.pack(xb)
        tree = reduce.reduce_tree(xb)
        got = reduce.reduce_sites(lb, "sum", layouts=L)
        assert got.dtype == torch.bfloat16 and _bits16(got, tree), spec
        assert _bits16(reduce.reduce_sites(_misaligned(lb), "sum", layouts=L), tree)
        assert _bits16(reduce.reduce_sites(lb, "sum", layouts=L, rsplit=4),
                       reduce.reduce_tree(xb, rsplit=4))
        want = xb.double().sum(dim=1).to(torch.bfloat16)
        assert bool(((got.double() - want.double()).abs() <= _bf16_ulp(want)).all()), spec
        assert _bits16(reduce.reduce_sites(lb, "max", layouts=L), xb.amax(dim=1))
        rows = reduce.reduce_sites_batched(torch.stack([lb, lb]), "sum", layouts=L)
        assert _bits16(rows[0], got) and _bits16(rows[1], got)


@pytest.mark.cuda
def test_split_launches_keep_field_bits(card, rng):
    """Under rsplit the fused kernels' field outputs are bitwise the unsplit
    launch's and the sums within SUM_RTOL of the plain ones: cg_update,
    cg_update_masked, wilson_normal (single, batched, the policy instance)
    through the wrappers, and the graphs under an explicit split plan; a
    target_sum under it bitwise the kernel's split fold."""
    lat = (4, 4, 8, 8)
    V = int(np.prod(lat))
    x, r, p, ap = (_dev(rng, (24, V), card) for _ in range(4))
    a = torch.tensor(0.3, device=card)
    base = fuse.cg_update(x, r, p, ap, a, -a, 32)
    for rs in (2, 4, 16):
        got = fuse.cg_update(x, r, p, ap, a, -a, 32, rsplit=rs)
        assert _bits(got[0], base[0]) and _bits(got[1], base[1])
        _close_sum(got[2], base[2], base[1] * base[1])
        m = torch.ones(2, device=card)
        gm = fuse.cg_update_masked(x, r, p, ap, a.repeat(2), -a.repeat(2), m, 32, rsplit=rs)
        assert _bits(gm[0][1], base[0]) and _bits(gm[2][0], got[2])
    u = torch.from_numpy(fields.random_su3_gauge(lat, seed=1).reshape(72, -1)).to(card)
    ap0, pap0 = K.wilson_normal_cuda(p, u, 0.12, lat, 32)
    for rs in (2, 8):
        ap1, pap1 = K.wilson_normal_cuda(p, u, 0.12, lat, 32, rsplit=rs)
        assert _bits(ap1, ap0)
        _close_sum(pap1, pap0, p * ap0)
        apb, papb = K.wilson_normal_cuda(torch.stack([p, p]), u, 0.12, lat, 32, batched=True,
                                         rsplit=rs)
        assert _bits(apb[0], ap0) and _bits(papb[1], pap1)
    from repro_torch.core.plan import CudaPolicy, LoweringPlan

    apc, papc = K.wilson_normal_cuda(p, u, 0.12, lat, 32, policy=CudaPolicy(False, True))
    apc2, papc2 = K.wilson_normal_cuda(p, u, 0.12, lat, 32, policy=CudaPolicy(False, True),
                                       rsplit=4)
    assert _bits(apc2, apc)
    _close_sum(papc2, papc, p * apc)
    fp = Field.from_canonical("p", p, lat)
    fu = Field.from_canonical("u", u, lat)
    split = TargetConfig("cuda", device="cuda",
                         plan_policy=LoweringPlan("cuda", vvl=32, bx=1, rsplit=4))
    whole = TargetConfig("cuda", device="cuda", vvl=32)
    g = CG.wilson_normal_graph(0.12)
    launches = reduce.REDUCE_FOLD_S.launches
    o4 = g.launch({"p": fp, "u": fu}, config=split, outputs=("ap", "pap"))
    o1 = g.launch({"p": fp, "u": fu}, config=whole, outputs=("ap", "pap"))
    assert reduce.REDUCE_FOLD_S.launches == launches + 1
    assert _bits(o4["ap"].data, o1["ap"].data)
    _close_sum(o4["pap"], o1["pap"], p * o1["ap"].data)
    prod = fp.with_data(p * p)
    assert _bits(reduce.target_sum(prod, split), reduce.reduce_tree(p * p, rsplit=4))


@pytest.mark.cuda
def test_block_view_launch_bitwise_staged(card, rng):
    """An explicit view="block" launch of wilson_normal (aosoa8, ring-2
    halos) and of the LB step (aosoa4, 8, 16) runs the same kernels as
    "staged-nd": every output bitwise; a misaligned block view raises
    before any launch."""
    from repro_torch.core.plan import LoweringPlan

    lat = (4, 4, 4, 4)
    lay = parse_layout("aosoa8")
    V = int(np.prod(lat))
    p = _dev(rng, (24, V), card)
    u = torch.from_numpy(fields.random_su3_gauge(lat, seed=1).reshape(72, -1)).to(card)
    ins = {"p": Field.from_canonical("p", p, lat, lay), "u": Field.from_canonical("u", u, lat, lay)}
    cfg = TargetConfig("cuda", device="cuda")
    g = CG.wilson_normal_graph(0.12)
    outs = [g.launch(ins, config=cfg, outputs=("ap", "pap"),
                     plan=LoweringPlan("cuda", vvl=128, bx=1, view=v))
            for v in ("staged-nd", "block")]
    assert _bits(outs[0]["ap"].data, outs[1]["ap"].data)
    assert _bits(outs[0]["pap"], outs[1]["pap"])
    llat = (4, 14, 16)
    LV = int(np.prod(llat))
    dist, force = _lb_dist(rng, card, LV), _dev(rng, (3, LV), card, scale=1e-3)
    lcfg = LudwigConfig(lattice=llat, target=cfg)
    for spec in ("aosoa4", "aosoa8", "aosoa16"):
        ll = parse_layout(spec)
        fins = {"dist": Field.from_canonical("dist", dist, llat, ll),
                "force": Field.from_canonical("force", force, llat, ll)}
        res = [LD.lb_step_graph(lcfg).launch(fins, config=cfg, outputs=("dist2", "u"),
                                             plan=LoweringPlan("cuda", vvl=32, bx=1, view=v))
               for v in ("staged-nd", "block")]
        for o in ("dist2", "u"):
            assert _bits(res[0][o].data, res[1][o].data), (spec, o)
    a64 = parse_layout("aosoa64")   # 64 does not divide the halo'd inner plane, 16 x 18
    bad = {n: f.as_layout(a64) for n, f in fins.items()}
    launches = K8.LB_STEP.launches
    with pytest.raises(ValueError, match="halo'd inner-plane"):
        LD.lb_step_graph(lcfg).launch(bad, config=cfg, outputs=("dist2", "u"),
                                      plan=LoweringPlan("cuda", vvl=128, bx=1, view="block"))
    assert K8.LB_STEP.launches == launches



# -- K3C (the fused LC chain), K5T (the tiled wilson_normal), K9 off SoA ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa4"])
def test_k3c_lc_chain(card, spec, rng):
    """K3C within 1e-6 x max|plain| of its plain version in a layout, and
    bitwise its SoA launch repacked."""
    lay = parse_layout(spec)
    lat = (8, 8, 16)
    V = int(np.prod(lat))
    arrs = {n: _dev(rng, (nc, V), card, sc) for n, nc, sc in
            (("q", 5, 0.05), ("lapq", 5, 0.02), ("w", 9, 0.01), ("adv", 5, 0.01))}
    kw = dict(a0=0.01, gamma=3.0, kappa=0.01, gamma_rot=0.3, xi=0.7, dt=1.0)
    L = {**{n: lay for n in arrs}, "q_new": lay}
    launches = LK.LC_CHAIN.launches
    got = LK.lc_chain_cuda(*(lay.pack(arrs[n]) for n in ("q", "lapq", "w", "adv")),
                           layouts=L, **kw)
    want = LK.lc_chain_plain(*(arrs[n] for n in ("q", "lapq", "w", "adv")), **kw)
    assert LK.LC_CHAIN.launches - launches == 1
    got_c = lay.unpack(got)
    assert (got_c - want).abs().max() <= 1e-6 * want.abs().max()
    soa = LK.lc_chain_cuda(*(arrs[n] for n in ("q", "lapq", "w", "adv")), **kw)
    assert _bits(got_c, soa)


K5T_LAT = (8, 8, 8, 16)
K5T_TILES = [(1, 1, 1), (2, 4, 2), (8, 2, 0), (1, 0, 4)]


def _normal_t(kernel, p, u, lat, lay, tile=None, batch=1):
    """t of K5's (tile None) or K5T's t kernel, launched alone."""
    V = int(np.prod(lat))
    t = torch.empty((batch, 24, V), device=p.device)
    lp, lu = lay.descriptor(), lay.descriptor()
    if tile is None:
        kernel.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(), 0.12, *lat, lp, lu, 128)
    else:
        kernel.launch(p.device, p.data_ptr(), u.data_ptr(), t.data_ptr(), 0.12, *lat, batch,
                      *tile, lp, lu, 128)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa4"])
@pytest.mark.parametrize("tile", K5T_TILES, ids=str)
def test_k5t_tiled_normal(card, spec, tile, rng):
    """K5T single, over 2 slots and under the refined solve's policy: t and
    ap bitwise K5's (the policy instance's), pap within 1e-6 x sum|terms| of
    the tile-ordered plain version and bitwise on a rerun; where the walk is
    the linear order, pap bitwise K5's; each slot bitwise the single
    launch."""
    lay = parse_layout(spec)
    lat, V = K5T_LAT, int(np.prod(K5T_LAT))
    u = lay.pack(torch.from_numpy(fields.random_su3_gauge(lat, seed=1, hot=0.6)).reshape(72, -1)
                 .to(card))
    p = lay.pack(_dev(rng, (24, V), card))
    L = {"p": lay, "u": lay, "ap": lay}
    ext = tuple(e or n for e, n in zip(tile, lat))
    t5 = _normal_t(K.WILSON_NORMAL_T, p, u, lat, lay)
    t9 = _normal_t(K.WILSON_NORMAL_T_TILED, p, u, lat, lay, ext)
    assert _bits(t5, t9)
    launches = K.WILSON_NORMAL_AP_TILED.launches
    ap, pap = K.wilson_normal_tiled_cuda(p, u, 0.12, lat, tile, layouts=L)
    assert K.WILSON_NORMAL_AP_TILED.launches - launches == 1
    ap5, pap5 = K.wilson_normal_cuda(p, u, 0.12, lat, 128, layouts=L)
    assert _bits(ap, ap5)
    want_ap, want = K.wilson_normal_tiled_plain(p, u, 0.12, lat, tile, L)
    terms = lay.unpack(p) * lay.unpack(want_ap)
    assert bool(((pap - want).abs() <= 1e-6 * terms.abs().sum(dim=1)).all())
    assert _bits(K.wilson_normal_tiled_cuda(p, u, 0.12, lat, tile, layouts=L)[1], pap)
    if torch.equal(K.normal_walk(lat, tile), torch.arange(V)):
        assert _bits(pap, pap5)
    # two slots, each the single launch
    p2 = torch.stack([p, lay.pack(_dev(rng, (24, V), card))])
    ap2, pap2 = K.wilson_normal_tiled_cuda(p2, u, 0.12, lat, tile, layouts=L, batched=True)
    for b in range(2):
        one = K.wilson_normal_tiled_cuda(p2[b], u, 0.12, lat, tile, layouts=L)
        assert _bits(ap2[b], one[0]) and _bits(pap2[b], one[1])
    # the policy instance: a bf16 u copy, ap in bf16, compensated pap
    pol = pplan.cuda_policy(DtypePolicy(storage="bfloat16", compute="float32",
                                        accumulate="float64"))
    u16 = K.bf16_pack_cuda(u)
    ap_m, pap_m = K.wilson_normal_tiled_cuda(p, u16, 0.12, lat, tile, layouts=L, policy=pol)
    ap5_m, _ = K.wilson_normal_cuda(p, u16, 0.12, lat, 128, layouts=L, policy=pol)
    assert _bits16(ap_m, ap5_m)
    want_ap, want = K.wilson_normal_tiled_plain(p, u, 0.12, lat, tile, L, policy=pol)
    terms = K.bf16_round(lay.unpack(p)) * lay.unpack(want_ap).float()
    assert bool(((pap_m - want).abs() <= 1e-6 * terms.abs().sum(dim=1)).all())
    assert _bits(K.wilson_normal_tiled_cuda(p, u16, 0.12, lat, tile, layouts=L,
                                            policy=pol)[1], pap_m)
    ap2m, pap2m = K.wilson_normal_tiled_cuda(p2, u16, 0.12, lat, tile, layouts=L, batched=True,
                                             policy=pol)
    assert _bits16(ap2m[0], ap_m) and _bits(pap2m[0], pap_m)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["aos", "aosoa4", "aosoa16"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_k9_in_every_layout_and_bf16(card, spec, bf16, rng):
    """K9 in a layout (and its policy instance) bitwise K5L's launch in
    that layout and policy, with and without u; under view='block' on
    aosoa4 through the graph, bitwise the untiled launch."""
    lay = parse_layout(spec)
    lat = (8, 8, 16)
    V = int(np.prod(lat))
    d, f = lay.pack(_lb_dist(rng, card, V)), lay.pack(_dev(rng, (3, V), card, scale=1e-3))
    L = {"dist": lay, "force": lay, "dist2": lay, "u": lay}
    k5 = K8.lb_step_cuda(d, f, 0.8, lat, 128, layouts=L, bf16=bf16)
    counter = K8.LB_STEP_TILED_BF16 if bf16 else K8.LB_STEP_TILED
    for tile in ((1, 4, 8), (8, 8, 16), (2, 2, 4)):
        launches = counter.launches
        got = K8.lb_step_tiled_cuda(d, f, 0.8, lat, tile, layouts=L, bf16=bf16)
        only, none = K8.lb_step_tiled_cuda(d, f, 0.8, lat, tile, layouts=L, bf16=bf16,
                                           with_u=False)
        assert counter.launches - launches == 2 and none is None
        for g, w in zip(got + (only,), k5 + (k5[0],)):
            assert _bits(g.float(), w.float()), (tile, g.dtype)
    if spec == "aosoa4" and not bf16:
        from repro_torch.core import LoweringPlan
        from repro_torch.kernels.lb_propagation.ops import collide_propagate

        fd, ff = Field("dist", 19, lat, lay, d), Field("force", 3, lat, lay, f)
        cfg = TargetConfig("cuda", device="cuda")
        want = collide_propagate(fd, ff, tau=0.8, config=cfg)
        launches = K8.LB_STEP_TILED.launches
        got = collide_propagate(fd, ff, tau=0.8, config=cfg,
                                plan=LoweringPlan("cuda", bx=1, by=4, bz=8, view="block"))
        assert K8.LB_STEP_TILED.launches - launches == 1 and _bits(got.data, want.data)


@pytest.mark.cuda
def test_budgeted_solves_run_k5t(card):
    """The MILC solve, solve_batched and the refined solve under the H100's
    227 KiB budget (the finest tile) run K5T, twice an iteration: the solve
    within 1 iteration and x rel-L2 1e-5 of the untiled one, each batched
    slot bitwise the budgeted solve of its source, the refined solve within
    x rel-L2 1e-4."""
    from repro_torch.apps.milc.driver import solve_batched

    kw = dict(lattice=(8, 8, 8, 8), kappa=0.12, tol=1e-10, max_iter=1000)
    cfg = MilcConfig(target=TargetConfig("cuda", device="cuda"), **kw)
    bud = MilcConfig(target=TargetConfig("cuda", device="cuda", smem_bytes=227 * 1024), **kw)
    u, b = init_problem(cfg, seed=0)
    base = solve(cfg, u, b)
    t0, a0 = K.WILSON_NORMAL_T_TILED.launches, K.WILSON_NORMAL_AP_TILED.launches
    res = solve(bud, u, b)
    assert K.WILSON_NORMAL_T_TILED.launches - t0 == res.iterations
    assert K.WILSON_NORMAL_AP_TILED.launches - a0 == res.iterations
    assert abs(res.iterations - base.iterations) <= 1
    rel = (torch.linalg.norm(res.x.data - base.x.data) / torch.linalg.norm(base.x.data)).item()
    assert rel <= 1e-5 and residual_check(bud, u, b, res.x) < 1e-3
    b2 = b.with_data(torch.flip(b.data, dims=(1,)))
    bat = solve_batched(bud, u, [b, b2])
    for k, src in enumerate((b, b2)):
        one = res if k == 0 else solve(bud, u, src)
        assert _bits(bat.x.element(k).data, one.x.data)
        assert int(bat.iterations[k]) == one.iterations
    m0 = K.WILSON_NORMAL_AP_TILED_MIXED.launches
    ref = solve(dataclasses.replace(bud, storage="bfloat16"), u, b)
    assert K.WILSON_NORMAL_AP_TILED_MIXED.launches > m0
    rel = (torch.linalg.norm(ref.x.data - base.x.data) / torch.linalg.norm(base.x.data)).item()
    assert rel <= 1e-4


# -- the decomposed lattice: K4H, K8H, K5H, K5LH on pre-exchanged halos -----------------

def _wrap(t, w):
    from repro_torch.core.stencil import halo_pad
    return halo_pad(t, w, range(1, t.dim())).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("lat", [(4, 4, 4, 8), (6, 5, 3, 32), (5, 3, 3, 7)], ids=str)
def test_k4h_dslash_halo(card, lat, width, rng):
    """K4H on random halo'd fields against its plain version (FIELD_RTOL),
    also through ``dslash_halo`` (on an interior no warp multiple divides,
    (5, 3, 3, 7), too), and on wrap-padded fields against K4's periodic SoA
    launch."""
    from repro_torch.kernels.wilson_dslash import dslash_halo
    hl = tuple(s + 2 * width for s in lat)
    psi, u = _dev(rng, (24,) + hl, card), _dev(rng, (72,) + hl, card)
    n0 = K.DSLASH_HALO.launches
    got = K.dslash_halo_cuda(psi, u, width)
    assert K.DSLASH_HALO.launches == n0 + 1
    _close_field(got, K.dslash_halo_plain(psi, u, width))
    op = dslash_halo(psi, u, config=TargetConfig("cuda", device="cuda"), width=width)
    assert K.DSLASH_HALO.launches == n0 + 2 and torch.equal(op, got)
    if int(np.prod(lat)) % 32:
        return   # the periodic K4 launch is held at lattices a warp multiple divides
    p0, u0 = _dev(rng, (24,) + lat, card), _dev(rng, (72,) + lat, card)
    per = K.dslash_cuda(p0.reshape(24, -1), u0.reshape(72, -1), lat, 128)
    _close_field(K.dslash_halo_cuda(_wrap(p0, width), _wrap(u0, width), width).reshape(24, -1),
                 per)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("lat", [(8, 8, 8), (5, 7, 3)], ids=str)
def test_k8h_propagate_halo_bitwise(card, lat, width, rng):
    """K8H bitwise its plain version at width 1 and 2, also through
    ``propagate_halo`` (whose (5, 7, 3) interior no warp multiple divides),
    and on a wrap-padded array bitwise K8's periodic launch."""
    from repro_torch.kernels.lb_propagation import propagate_halo
    hl = tuple(s + 2 * width for s in lat)
    f = _dev(rng, (19,) + hl, card)
    want = K8.propagate_halo_plain(f, width)
    assert torch.equal(K8.propagate_halo_cuda(f, width), want)
    n0 = K8.PROPAGATE_HALO.launches
    got = propagate_halo(f, config=TargetConfig("cuda", device="cuda"), width=width)
    assert K8.PROPAGATE_HALO.launches == n0 + 1 and torch.equal(got, want)
    f0 = _dev(rng, (19,) + lat, card)
    assert torch.equal(K8.propagate_halo_cuda(_wrap(f0, width), width).reshape(19, -1),
                       K8.propagate_cuda(f0.reshape(19, -1), lat))


@pytest.mark.cuda
@pytest.mark.parametrize("lat", [(4, 4, 4, 8), (6, 4, 2, 32), (5, 7, 3, 9), (9, 6, 10, 18)],
                         ids=str)
def test_k5h_wilson_normal_pre(card, lat, rng):
    """K5H (the wilson_normal graph under halo="pre", two launches) against
    its plain version, on random halo'd inputs and on wrap-padded ones
    against K5's periodic ap; the graph's "pre" launch on the cuda engine
    runs K5H and nothing else."""
    hl = tuple(s + 4 for s in lat)
    Vh = int(np.prod(hl))
    p, u = _dev(rng, (24, Vh), card), _dev(rng, (72, Vh), card)
    _close_field(K.wilson_normal_pre_cuda(p, u, 0.12, lat),
                 K.wilson_normal_pre_plain(p, u, 0.12, lat))
    p0, u0 = _dev(rng, (24,) + lat, card), _dev(rng, (72,) + lat, card)
    ap, _ = K.wilson_normal_cuda(p0.reshape(24, -1), u0.reshape(72, -1), 0.12, lat, 128)
    ph, uh = _wrap(p0, 2).reshape(24, -1), _wrap(u0, 2).reshape(72, -1)
    _close_field(K.wilson_normal_pre_cuda(ph, uh, 0.12, lat), ap)
    n = (K.WILSON_NORMAL_PRE_T.launches, K.WILSON_NORMAL_PRE_AP.launches,
         K.WILSON_NORMAL_T.launches)
    out = CG.wilson_normal_graph(0.12).launch(
        {"p": Field.from_canonical("p", ph, hl), "u": Field.from_canonical("u", uh, hl)},
        config=TargetConfig("cuda", device="cuda"), outputs=("ap",), halo="pre")
    assert (K.WILSON_NORMAL_PRE_T.launches - n[0], K.WILSON_NORMAL_PRE_AP.launches - n[1],
            K.WILSON_NORMAL_T.launches - n[2]) == (1, 1, 0)
    _close_field(out["ap"].data, ap)


@pytest.mark.cuda
def test_k5h_graph_pre_launch_on_an_interior_no_warp_multiple_divides(card, rng):
    """The wilson_normal graph's "pre" launch at the interior (3, 5, 3, 7)
    (315 sites): the planner's block size need not divide it, K5H runs
    and agrees with its plain version (FIELD_RTOL)."""
    lat = (3, 5, 3, 7)
    hl = tuple(s + 4 for s in lat)
    Vh = int(np.prod(hl))
    p, u = _dev(rng, (24, Vh), card), _dev(rng, (72, Vh), card)
    n0 = K.WILSON_NORMAL_PRE_AP.launches
    out = CG.wilson_normal_graph(0.12).launch(
        {"p": Field.from_canonical("p", p, hl), "u": Field.from_canonical("u", u, hl)},
        config=TargetConfig("cuda", device="cuda"), outputs=("ap",), halo="pre")
    assert K.WILSON_NORMAL_PRE_AP.launches == n0 + 1
    _close_field(out["ap"].data, K.wilson_normal_pre_plain(p, u, 0.12, lat))


@pytest.mark.cuda
@pytest.mark.parametrize("lat", [(8, 8, 8), (5, 7, 3), (16, 4, 33)], ids=str)
def test_k5lh_lb_step_pre_bitwise(card, lat, rng):
    """K5LH's dist2 and u bitwise its plain version (the collision's pinned
    roundings hold on the ring), and on wrap-padded inputs bitwise K5L's
    periodic launch; the graph's "pre" launch runs K5LH."""
    hl = tuple(s + 2 for s in lat)
    Vh = int(np.prod(hl))
    d, f = _lb_dist(rng, card, Vh), _dev(rng, (3, Vh), card, scale=1e-3)
    got = K8.lb_step_pre_cuda(d, f, 0.8, lat)
    want = K8.lb_step_pre_plain(d, f, 0.8, lat)
    assert _bits(got[0], want[0]) and _bits(got[1], want[1])
    V = int(np.prod(lat))
    d0, f0 = _lb_dist(rng, card, V), _dev(rng, (3, V), card, scale=1e-3)
    per = K8.lb_step_cuda(d0, f0, 0.8, lat, 128)
    dh = _wrap(d0.reshape((19,) + lat), 1).reshape(19, -1)
    fh = _wrap(f0.reshape((3,) + lat), 1).reshape(3, -1)
    pre = K8.lb_step_pre_cuda(dh, fh, 0.8, lat)
    assert _bits(pre[0], per[0]) and _bits(pre[1], per[1])
    n0, n1 = K8.LB_STEP_PRE.launches, K8.LB_STEP.launches
    out = LD.lb_step_graph(LudwigConfig(lattice=lat)).launch(
        {"dist": Field.from_canonical("dist", dh, hl),
         "force": Field.from_canonical("force", fh, hl)},
        config=TargetConfig("cuda", device="cuda"), outputs=("dist2", "u"), halo="pre")
    assert (K8.LB_STEP_PRE.launches - n0, K8.LB_STEP.launches - n1) == (1, 0)
    assert _bits(out["dist2"].data, per[0]) and _bits(out["u"].data, per[1])


@pytest.mark.cuda
def test_one_rank_sharded_paths_on_the_card(card):
    """A one-rank mesh on the card: 3 sharded Ludwig steps bitwise the cuda
    engine's single steps; the sharded MILC solve under None and "pre"
    within 1 iteration and x rel-L2 1e-5 of the single solve."""
    from repro_torch.apps.ludwig.driver import make_sharded_step
    from repro_torch.apps.milc.driver import make_domain, make_sharded_solver
    from repro_torch.lattice import Domain
    from repro_torch.launch.mesh import Mesh

    tgt = TargetConfig("cuda", device="cuda")
    cfg = LudwigConfig(lattice=(16, 8, 8), target=tgt)
    st = init_state(cfg, seed=0)
    mesh = Mesh((1, 1, 1), ("x", "y", "z"), rank=0, world_size=1, local_rank=0)
    dom = Domain(cfg.lattice, mesh, ("x", "y", "z"), halo=2)
    sstep = make_sharded_step(cfg, dom)
    d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
    s = st
    n0 = K8.LB_STEP_PRE.launches
    for _ in range(3):
        s = step(s, cfg)
        d, q = sstep(d, q)
    assert K8.LB_STEP_PRE.launches - n0 == 3
    assert _bits(d, s.dist.canonical_nd()) and _bits(q, s.q.canonical_nd())
    mc = MilcConfig(lattice=(8, 8, 8, 8), kappa=0.12, tol=1e-10, max_iter=1000, target=tgt)
    u, b = init_problem(mc, seed=0)
    base = solve(mc, u, b)
    m4 = Mesh((1, 1, 1, 1), ("x", "y", "z", "t"), rank=0, world_size=1, local_rank=0)
    md = make_domain(mc, m4, ("x", "y", "z", "t"))
    for halo in (None, "pre"):
        n0 = K.WILSON_NORMAL_PRE_AP.launches
        x, it, _ = make_sharded_solver(mc, md, halo)(md.scatter(u.canonical_nd()),
                                                    md.scatter(b.canonical_nd()))
        assert K.WILSON_NORMAL_PRE_AP.launches - n0 == (it if halo else 0)
        assert abs(it - base.iterations) <= 1
        ref = base.x.canonical_nd()
        assert (torch.linalg.norm(x - ref) / torch.linalg.norm(ref)).item() <= 1e-5


# -- the overlap schedule: K5HO and K5LHO on boxes, the exchange on a side stream --------

def _split(lat, ring, dims=None):
    from repro_torch.core.overlap import split_boxes
    interior, boundary = split_boxes(lat, ring, range(len(lat)) if dims is None else dims)
    return [(tuple(a for a, _ in bx), tuple(b - a for a, b in bx)) for bx in [interior] + boundary]


def _box(t, lat, o, e):
    return t.reshape((t.shape[0],) + tuple(lat))[
        (slice(None),) + tuple(slice(a, a + b) for a, b in zip(o, e))]


def _k5ho_split(p, u, lat, boxes, t=None, ap=None):
    """K5HO's two parts on a split (interior, then boundary) into fresh
    NaN-filled t and ap."""
    V = int(np.prod(lat))
    t = torch.full((24, int(np.prod([s + 2 for s in lat]))), float("nan"), device=p.device)
    ap = torch.full((24, V), float("nan"), device=p.device)
    K.wilson_normal_interior_cuda(p, u, 0.12, lat, boxes[0], t, ap)
    if len(boxes) > 1:
        K.wilson_normal_boundary_cuda(p, u, 0.12, lat, boxes[0], boxes[1:], t, ap)
    return t, ap


@pytest.mark.cuda
@pytest.mark.parametrize("lat,dims", [((8, 8, 8, 8), None), ((6, 5, 7, 32), (0, 2)),
                                      ((5, 9, 6, 7), (1, 3))], ids=str)
def test_k5ho_wilson_normal_box(card, lat, dims, rng):
    """K5HO on a split's box tables: each box within FIELD_RTOL of its plain
    version and bitwise K5H's sites there (the same arithmetic a site), the
    assembled ap bitwise K5H's, t computed on every ring-1 site; two
    launches a part, four a split."""
    hl = tuple(s + 4 for s in lat)
    Vh = int(np.prod(hl))
    p, u = _dev(rng, (24, Vh), card), _dev(rng, (72, Vh), card)
    whole = K.wilson_normal_pre_cuda(p, u, 0.12, lat)
    boxes = _split(lat, 2, dims)
    n0 = (K.WILSON_NORMAL_BOX_T.launches, K.WILSON_NORMAL_BOX_AP.launches)
    t, ap = _k5ho_split(p, u, lat, boxes)
    assert (K.WILSON_NORMAL_BOX_T.launches - n0[0],
            K.WILSON_NORMAL_BOX_AP.launches - n0[1]) == (2, 2)
    for o, e in boxes:
        got = _box(ap, lat, o, e)
        _close_field(got.reshape(24, -1), K.wilson_normal_box_plain(p, u, 0.12, lat, o, e))
        assert _bits(got, _box(whole, lat, o, e))
    assert _bits(ap, whole) and not t.isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("lat", [(6, 7, 5, 6), (10, 10, 4, 4)], ids=str)
def test_k5ho_box_tables_bitwise_k5h_on_every_split(card, lat, rng):
    """K5HO bitwise K5H on every site for every split of 1-4 decomposed dims
    that leaves an interior (the shell's and the boundary's T-slabs paired
    where T is split)."""
    import itertools
    hl = tuple(s + 4 for s in lat)
    Vh = int(np.prod(hl))
    p, u = _dev(rng, (24, Vh), card), _dev(rng, (72, Vh), card)
    whole = K.wilson_normal_pre_cuda(p, u, 0.12, lat)
    for r in range(1, 5):
        for dims in itertools.combinations(range(4), r):
            if any(lat[d] < 5 for d in dims):   # ring 2 leaves no interior
                continue
            t, ap = _k5ho_split(p, u, lat, _split(lat, 2, dims))
            assert _bits(ap, whole) and not t.isnan().any(), dims


@pytest.mark.cuda
@pytest.mark.parametrize("lat,dims", [((8, 8, 8), None), ((5, 7, 3), (0, 1)),
                                      ((16, 4, 33), (2,))], ids=str)
def test_k5lho_lb_step_box_bitwise(card, lat, dims, rng):
    """K5LHO on every box of a split: dist2 and u bitwise its plain version
    and K5LH's sites there, the assembled outputs bitwise K5LH's."""
    hl = tuple(s + 2 for s in lat)
    Vh, V = int(np.prod(hl)), int(np.prod(lat))
    d, f = _lb_dist(rng, card, Vh), _dev(rng, (3, Vh), card, scale=1e-3)
    w2, wu = K8.lb_step_pre_cuda(d, f, 0.8, lat)
    d2 = torch.full((19, V), float("nan"), device=card)
    u = torch.full((3, V), float("nan"), device=card)
    for o, e in _split(lat, 1, dims):
        K8.lb_step_box_cuda(d, f, 0.8, lat, o, e, d2, u)
        pd, pu = K8.lb_step_box_plain(d, f, 0.8, lat, o, e)
        assert _bits(_box(d2, lat, o, e).reshape(19, -1), pd)
        assert _bits(_box(u, lat, o, e).reshape(3, -1), pu)
        assert _bits(_box(d2, lat, o, e), _box(w2, lat, o, e))
    assert _bits(d2, w2) and _bits(u, wu)


# -- the sharded plans: K9H, K5TH and tiled K5HO -----------------------------------------

K9H_LAYOUTS = ("soa", "aos", "aosoa4")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", K9H_LAYOUTS)
@pytest.mark.parametrize("lat,tile", [((8, 8, 8), (1, 4, 8)), ((4, 6, 8), (2, 3, 4)),
                                      ((16, 4, 32), (16, 4, 32))], ids=str)
def test_k9h_lb_step_halo_bitwise(card, lat, tile, spec, rng):
    """K9H (lb_step_halo) on the whole interior, untiled and at ``tile``,
    in ``spec`` (every field), with u (ludwig_lb_step) and without
    (lb_collide_propagate): dist2 and u bitwise K5LH's, unpacked, and
    bitwise its plain version in that layout; on every box of a split, in
    the box's tiles, the assembled outputs bitwise K5LH's."""
    lay = parse_layout(spec)
    lays = {n: lay for n in ("dist", "force", "dist2", "u")}
    hl = tuple(s + 2 for s in lat)
    Vh, V = int(np.prod(hl)), int(np.prod(lat))
    d, f = _lb_dist(rng, card, Vh), _dev(rng, (3, Vh), card, scale=1e-3)
    w2, wu = K8.lb_step_pre_cuda(d, f, 0.8, lat)
    dl, fl = lay.pack(d), lay.pack(f)
    for tl in (None, tile):
        for with_u in (True, False):
            if tl is None and spec == "soa":
                continue   # K5LH itself
            n0 = K8.LB_STEP_HALO.launches
            g2, gu = K8.lb_step_pre_cuda(dl, fl, 0.8, lat, 64, with_u, tile=tl, layouts=lays)
            assert K8.LB_STEP_HALO.launches == n0 + 1
            assert _bits(lay.unpack(g2), w2) and (not with_u or _bits(lay.unpack(gu), wu))
            p2, pu = K8.lb_step_pre_plain(dl, fl, 0.8, lat, with_u, tile=tl, layouts=lays)
            assert _bits(g2, p2) and (not with_u or _bits(gu, pu))
    d2 = torch.full(lay.physical_shape(19, V), float("nan"), device=card)
    u = torch.full(lay.physical_shape(3, V), float("nan"), device=card)
    for o, e in _split(lat, 1):
        bt = tuple(next(x for x in range(2, n + 1) if n % x == 0) if n > 1 else 1 for n in e)
        K8.lb_step_box_cuda(dl, fl, 0.8, lat, o, e, d2, u, 64, tile=bt, layouts=lays)
    assert _bits(lay.unpack(d2), w2) and _bits(lay.unpack(u), wu)


@pytest.mark.cuda
@pytest.mark.parametrize("lat,tile", [((8, 8, 8, 8), (1, 1, 1)), ((8, 8, 8, 8), (2, 4, 8)),
                                      ((6, 5, 5, 5), (3, 5, 1)), ((4, 8, 8, 32), (2, 4, 8))],
                         ids=str)
def test_k5th_wilson_normal_pre_tiled_bitwise_k5h(card, lat, tile, rng):
    """K5TH (K5H's kernels walking the tile order: ap the interior, t the
    ring-1 array) bitwise K5H at the budget's tile (1, 1, 1) and at
    K5T_WALK_TILE-like tiles whose walk is not the identity, within
    FIELD_RTOL of its plain version (the tiles' windows); two launches."""
    hl = tuple(s + 4 for s in lat)
    Vh = int(np.prod(hl))
    p, u = _dev(rng, (24, Vh), card), _dev(rng, (72, Vh), card)
    whole = K.wilson_normal_pre_cuda(p, u, 0.12, lat)
    n0 = (K.WILSON_NORMAL_PRE_T_TILED.launches, K.WILSON_NORMAL_PRE_AP_TILED.launches)
    got = K.wilson_normal_pre_cuda(p, u, 0.12, lat, tile=tile)
    assert (K.WILSON_NORMAL_PRE_T_TILED.launches - n0[0],
            K.WILSON_NORMAL_PRE_AP_TILED.launches - n0[1]) == (1, 1)
    assert _bits(got, whole)
    _close_field(got, K.wilson_normal_pre_plain(p, u, 0.12, lat, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("lat", [(6, 7, 5, 6), (10, 10, 4, 4)], ids=str)
def test_tiled_k5ho_box_tables_bitwise_k5h_on_every_split(card, lat, rng):
    """Tiled K5HO: the ap tables' rows in each box's sub-plan tiles (an
    outer plan with y and z tiles), bitwise K5H on every split of 1-4
    decomposed dims; four launches a split, the two ap launches tiled."""
    import itertools
    hl = tuple(s + 4 for s in lat)
    Vh = int(np.prod(hl))
    p, u = _dev(rng, (24, Vh), card), _dev(rng, (72, Vh), card)
    whole = K.wilson_normal_pre_cuda(p, u, 0.12, lat)
    outer = pplan.LoweringPlan("cuda", vvl=64, bx=1, by=lat[1], bz=1, halo="overlap")
    cfg = TargetConfig("cuda", device="cuda", vvl=64)
    for r in range(1, 5):
        for dims in itertools.combinations(range(4), r):
            if any(lat[d] < 5 for d in dims):
                continue
            boxes = _split(lat, 2, dims)
            tiles = [pplan.plan_tile(pplan.sub_lattice_plan(outer, cfg, e)) for _, e in boxes]
            t = torch.full((24, int(np.prod([s + 2 for s in lat]))), float("nan"), device=card)
            ap = torch.full((24, int(np.prod(lat))), float("nan"), device=card)
            n0 = (K.WILSON_NORMAL_BOX_T.launches, K.WILSON_NORMAL_BOX_AP_TILED.launches)
            K.wilson_normal_interior_cuda(p, u, 0.12, lat, boxes[0], t, ap, tile=tiles[0])
            K.wilson_normal_boundary_cuda(p, u, 0.12, lat, boxes[0], boxes[1:], t, ap,
                                          tiles=tiles[1:])
            assert (K.WILSON_NORMAL_BOX_T.launches - n0[0],
                    K.WILSON_NORMAL_BOX_AP_TILED.launches - n0[1]) == (2, 2), dims
            assert _bits(ap, whole) and not t.isnan().any(), dims


@pytest.mark.cuda
def test_k9h_k5th_graph_launches_under_plans(card, rng):
    """The graphs' "pre" launches on the cuda engine under a tiled plan, in
    aosoa4 under the block view and with rsplit run K9H (both LB graphs)
    and K5TH, never K5LH or K5H, bitwise the untiled SoA launches; under
    "overlap" with tiles, tiled K5HO and K9H on the boxes."""
    from repro_torch.kernels.lb_propagation.ops import collide_propagate_graph
    tgt = TargetConfig("cuda", device="cuda", vvl=64)
    lat = (8, 8, 16)
    hl = tuple(s + 2 for s in lat)
    Vh = int(np.prod(hl))
    d, f = _lb_dist(rng, card, Vh), _dev(rng, (3, Vh), card, scale=1e-3)
    a4 = parse_layout("aosoa4")
    for g, outs in ((LD.lb_step_graph(LudwigConfig(lattice=lat)), ("dist2", "u")),
                    (collide_propagate_graph(0.8), ("dist2",))):
        base = g.launch({"dist": Field.from_canonical("dist", d, hl),
                         "force": Field.from_canonical("force", f, hl)}, config=tgt,
                        outputs=outs, halo="pre")
        for lay, plan in ((SOA, pplan.LoweringPlan("cuda", vvl=64, bx=1, by=2, bz=8)),
                          (a4, pplan.LoweringPlan("cuda", vvl=64, bx=1, view="block")),
                          (a4, pplan.LoweringPlan("cuda", vvl=64, bx=2, by=4, rsplit=2)),
                          (a4, pplan.LoweringPlan("cuda", vvl=64, bx=1, by=4, bz=8,
                                                  halo="overlap"))):
            n = (K8.LB_STEP_HALO.launches, K8.LB_STEP_PRE.launches, K8.LB_STEP_BOX.launches)
            halo = plan.halo if plan.halo == "overlap" else "pre"
            out = g.launch({"dist": Field.from_canonical("dist", d, hl, lay),
                            "force": Field.from_canonical("force", f, hl, lay)}, config=tgt,
                           outputs=outs, halo=halo, plan=plan)
            assert K8.LB_STEP_HALO.launches > n[0], plan.describe()
            assert (K8.LB_STEP_PRE.launches, K8.LB_STEP_BOX.launches) == n[1:], plan.describe()
            for o in outs:
                assert out[o].layout == lay and _bits(out[o].canonical(), base[o].canonical())
    lat = (8, 8, 8, 8)
    hl = tuple(s + 4 for s in lat)
    p, u = (_dev(rng, (n, int(np.prod(hl))), card) for n in (24, 72))
    ins = {"p": Field.from_canonical("p", p, hl), "u": Field.from_canonical("u", u, hl)}
    g = CG.wilson_normal_graph(0.12)
    pre = g.launch(ins, config=tgt, outputs=("ap",), halo="pre")["ap"]
    n = (K.WILSON_NORMAL_PRE_AP_TILED.launches, K.WILSON_NORMAL_PRE_AP.launches)
    budget = dataclasses.replace(tgt, smem_bytes=227 * 1024)
    got = g.launch(ins, config=budget, outputs=("ap",), halo="pre")["ap"]
    assert (K.WILSON_NORMAL_PRE_AP_TILED.launches - n[0], K.WILSON_NORMAL_PRE_AP.launches - n[1]) \
        == (1, 0)
    assert _bits(got.data, pre.data)
    n = K.WILSON_NORMAL_BOX_AP_TILED.launches
    ov = g.launch(ins, config=tgt, outputs=("ap",), halo="overlap",
                  plan=pplan.LoweringPlan("cuda", vvl=64, bx=2, by=8, bz=4, halo="overlap"))["ap"]
    assert K.WILSON_NORMAL_BOX_AP_TILED.launches - n == 2 and _bits(ov.data, pre.data)


@pytest.mark.cuda
def test_k9h_sharded_steps_in_aosoa4_under_pre_and_overlap(card):
    """One-rank sharded Ludwig steps in aosoa4 under an explicit block-view
    plan, "pre" and "overlap" (the AoSoA inputs' canonical copies made
    before the fill's mark, which the side stream's exchange waits for):
    3 steps each bitwise the SoA "pre" steps, K9H on every LB launch."""
    from repro_torch.apps.ludwig.driver import make_sharded_step
    from repro_torch.lattice import Domain
    from repro_torch.launch.mesh import Mesh

    tgt = TargetConfig("cuda", device="cuda")
    cfg = LudwigConfig(lattice=(16, 8, 8), target=tgt)
    st = init_state(cfg, seed=0)
    mesh = Mesh((1, 1, 1), ("x", "y", "z"), rank=0, world_size=1, local_rank=0)
    dom = Domain(cfg.lattice, mesh, ("x", "y", "z"), halo=2)

    def run(c, halo):
        sstep = make_sharded_step(c, dom, halo)
        d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
        for _ in range(3):
            d, q = sstep(d, q)
        return d, q

    d0, q0 = run(cfg, "pre")
    a4 = dataclasses.replace(cfg, layout=parse_layout("aosoa4"), target=dataclasses.replace(
        tgt, plan_policy=pplan.LoweringPlan("cuda", vvl=64, bx=1, view="block")))
    for halo in ("pre", "overlap"):
        n0 = K8.LB_STEP_HALO.launches
        d, q = run(a4, halo)
        assert K8.LB_STEP_HALO.launches - n0 >= 3, halo
        assert _bits(d, d0) and _bits(q, q0), halo


@pytest.mark.cuda
def test_overlap_graph_launches_run_only_the_box_kernels(card, rng):
    """The graphs' "overlap" launches on the cuda engine (execute_split:
    every dim split) run the box kernels, never K5H or K5LH, and are
    bitwise their "pre" launches; pap under "overlap" raises, as under
    "pre"."""
    tgt = TargetConfig("cuda", device="cuda")
    lat = (6, 6, 6, 8)
    hl = tuple(s + 4 for s in lat)
    p, u = (_dev(rng, (n, int(np.prod(hl))), card) for n in (24, 72))
    ins = {"p": Field.from_canonical("p", p, hl), "u": Field.from_canonical("u", u, hl)}
    g = CG.wilson_normal_graph(0.12)
    pre = g.launch(ins, config=tgt, outputs=("ap",), halo="pre")["ap"]
    n = (K.WILSON_NORMAL_PRE_AP.launches, K.WILSON_NORMAL_BOX_AP.launches)
    ov = g.launch(ins, config=tgt, outputs=("ap",), halo="overlap")["ap"]
    assert (K.WILSON_NORMAL_PRE_AP.launches - n[0], K.WILSON_NORMAL_BOX_AP.launches - n[1]) == \
        (0, 2)
    assert _bits(ov.data, pre.data)
    with pytest.raises(ValueError, match="produces"):
        g.launch(ins, config=tgt, outputs=("ap", "pap"), halo="overlap")
    lat3 = (8, 6, 10)
    hl3 = tuple(s + 2 for s in lat3)
    Vh = int(np.prod(hl3))
    lins = {"dist": Field.from_canonical("dist", _lb_dist(rng, card, Vh), hl3),
            "force": Field.from_canonical("force", _dev(rng, (3, Vh), card, scale=1e-3), hl3)}
    lg = LD.lb_step_graph(LudwigConfig(lattice=lat3))
    pre = lg.launch(lins, config=tgt, outputs=("dist2", "u"), halo="pre")
    n = (K8.LB_STEP_PRE.launches, K8.LB_STEP_BOX.launches)
    ov = lg.launch(lins, config=tgt, outputs=("dist2", "u"), halo="overlap")
    assert (K8.LB_STEP_PRE.launches - n[0], K8.LB_STEP_BOX.launches - n[1]) == (0, 7)
    assert _bits(ov["dist2"].data, pre["dist2"].data) and _bits(ov["u"].data, pre["u"].data)


@pytest.mark.cuda
def test_two_stream_overlap_launch_bitwise_pre_over_20_repeats(card, rng, monkeypatch):
    """overlap_launch on a one-rank mesh of four axes: p filled, its
    exchange on the side stream beside the interior box (K5HO), 20 times,
    each time on a freshly allocated halo'd p that is dropped afterwards
    (a tensor reused early by the caching allocator would show as wrong
    bits), and the same for the LB graph: bitwise the "pre" launch on the
    exchanged arrays every time; the interior's two kernels are issued
    before the exchange starts, the boundary's two after it."""
    from repro_torch.core import halo as H
    from repro_torch.core.overlap import overlap_launch
    from repro_torch.launch.mesh import Mesh

    at_start = []
    start = H.start_exchange

    def spy(*a, **kw):
        at_start.append((K.WILSON_NORMAL_BOX_T.launches, K.WILSON_NORMAL_BOX_AP.launches))
        return start(*a, **kw)

    monkeypatch.setattr(H, "start_exchange", spy)

    tgt = TargetConfig("cuda", device="cuda")
    mesh = Mesh((1, 1, 1, 1), ("x", "y", "z", "t"), rank=0, world_size=1, local_rank=0)
    dec = tuple((d + 1, ax, 1) for d, ax in enumerate(("x", "y", "z", "t")))
    lat = (12, 10, 8, 16)
    g = CG.wilson_normal_graph(0.12)
    u0 = _dev(rng, (72,) + lat, card)
    uh = H.exchange_padded(u0, dec, width=2, mesh=mesh)
    uF = Field.from_canonical("u", uh, tuple(uh.shape[1:]))
    n0 = K.WILSON_NORMAL_BOX_AP.launches
    for i in range(20):
        n = (K.WILSON_NORMAL_BOX_T.launches, K.WILSON_NORMAL_BOX_AP.launches)
        p0 = _dev(rng, (24,) + lat, card)
        want = g.launch({"p": Field.from_canonical("p", H.exchange_padded(p0, dec, width=2,
                                                                          mesh=mesh),
                                                   tuple(uh.shape[1:])), "u": uF},
                        config=tgt, outputs=("ap",), halo="pre")["ap"]
        ph = H.fill_padded(p0, dec, width=2)
        got = overlap_launch(g, {"p": Field.from_canonical("p", ph, tuple(ph.shape[1:])),
                                 "u": uF}, decomposed=dec, config=tgt, outputs=("ap",),
                             halo="overlap", exchanged=("u",), mesh=mesh)["ap"]
        del ph
        torch.empty_like(uh).fill_(float("nan"))   # reuse freed blocks, if any are free
        assert _bits(got.data, want.data), i
        assert at_start[-1] == (n[0] + 1, n[1] + 1), i     # the interior came first
        assert (K.WILSON_NORMAL_BOX_T.launches, K.WILSON_NORMAL_BOX_AP.launches) == \
            (n[0] + 2, n[1] + 2), i
    assert K.WILSON_NORMAL_BOX_AP.launches - n0 == 20 * 2
    m3 = Mesh((1, 1, 1), ("x", "y", "z"), rank=0, world_size=1, local_rank=0)
    dec3 = tuple((d + 1, ax, 1) for d, ax in enumerate(("x", "y", "z")))
    lat3 = (32, 16, 24)
    lg = LD.lb_step_graph(LudwigConfig(lattice=lat3))
    for i in range(20):
        d0 = _lb_dist(rng, card, int(np.prod(lat3))).reshape((19,) + lat3)
        f0 = _dev(rng, (3,) + lat3, card, scale=1e-3)
        hl = tuple(s + 2 for s in lat3)
        want = lg.launch({"dist": Field.from_canonical("dist", H.exchange_padded(
                              d0, dec3, width=1, mesh=m3), hl),
                          "force": Field.from_canonical("force", H.exchange_padded(
                              f0, dec3, width=1, mesh=m3), hl)},
                         config=tgt, outputs=("dist2", "u"), halo="pre")
        got = overlap_launch(lg, {"dist": Field.from_canonical(
                                      "dist", H.fill_padded(d0, dec3, width=1), hl),
                                  "force": Field.from_canonical(
                                      "force", H.fill_padded(f0, dec3, width=1), hl)},
                             decomposed=dec3, config=tgt, outputs=("dist2", "u"),
                             halo="overlap", mesh=m3)
        assert _bits(got["dist2"].data, want["dist2"].data), i
        assert _bits(got["u"].data, want["u"].data), i


@pytest.mark.cuda
def test_one_rank_overlap_paths_on_the_card(card):
    """A one-rank mesh on the card: the sharded MILC solve under "overlap"
    with "pre"'s iterations and x bitwise, K5HO's four kernels an iteration
    and no K5H; 3 sharded Ludwig steps under "overlap" bitwise
    the "pre" steps, K5LHO 7 launches a step and no K5LH."""
    from repro_torch.apps.ludwig.driver import make_sharded_step
    from repro_torch.apps.milc.driver import make_domain, make_sharded_solver
    from repro_torch.lattice import Domain
    from repro_torch.launch.mesh import Mesh

    tgt = TargetConfig("cuda", device="cuda")
    mc = MilcConfig(lattice=(8, 8, 8, 8), kappa=0.12, tol=1e-10, max_iter=1000, target=tgt)
    u, b = init_problem(mc, seed=0)
    m4 = Mesh((1, 1, 1, 1), ("x", "y", "z", "t"), rank=0, world_size=1, local_rank=0)
    md = make_domain(mc, m4, ("x", "y", "z", "t"))
    ul, bl = md.scatter(u.canonical_nd()), md.scatter(b.canonical_nd())
    xp, itp, _ = make_sharded_solver(mc, md, "pre")(ul, bl)
    n = (K.WILSON_NORMAL_PRE_AP.launches, K.WILSON_NORMAL_BOX_T.launches,
         K.WILSON_NORMAL_BOX_AP.launches)
    x, it, _ = make_sharded_solver(mc, md, "overlap")(ul, bl)
    assert it == itp and _bits(x, xp)
    # four K5HO kernels an operator: interior t and ap, shell t, boundary ap
    assert (K.WILSON_NORMAL_PRE_AP.launches - n[0], K.WILSON_NORMAL_BOX_T.launches - n[1],
            K.WILSON_NORMAL_BOX_AP.launches - n[2]) == (0, 2 * it, 2 * it)
    cfg = LudwigConfig(lattice=(16, 8, 8), target=tgt)
    st = init_state(cfg, seed=0)
    mesh = Mesh((1, 1, 1), ("x", "y", "z"), rank=0, world_size=1, local_rank=0)
    dom = Domain(cfg.lattice, mesh, ("x", "y", "z"), halo=2)
    out = {}
    for halo in ("pre", "overlap"):
        sstep = make_sharded_step(cfg, dom, halo)
        d, q = dom.scatter(st.dist.canonical_nd()), dom.scatter(st.q.canonical_nd())
        n = (K8.LB_STEP_PRE.launches, K8.LB_STEP_BOX.launches)
        for _ in range(3):
            d, q = sstep(d, q)
        out[halo] = (d, q, K8.LB_STEP_PRE.launches - n[0], K8.LB_STEP_BOX.launches - n[1])
    assert out["pre"][2:] == (3, 0) and out["overlap"][2:] == (0, 21)
    assert _bits(out["overlap"][0], out["pre"][0]) and _bits(out["overlap"][1], out["pre"][1])
