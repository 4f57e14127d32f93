"""Port parity for the Ludwig LC-LB timestep: the liquid-crystal chunks,
the gradient stencils, the fused launch graphs, init_state, step and
diagnostics against the JAX package; tests/test_ludwig.py's physics on the
port; the Ludwig state carried across; and the refusals."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps.ludwig import LudwigConfig as JLudwigConfig  # noqa: E402
from repro.apps.ludwig import driver as JD  # noqa: E402
from repro.apps.ludwig import gradients as JGR  # noqa: E402
from repro.apps.ludwig import lc as JLC  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import parse_layout as j_parse_layout  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps.ludwig import LudwigConfig, LudwigState, init_state, step  # noqa: E402
from repro_torch.apps.ludwig import driver as PD  # noqa: E402
from repro_torch.apps.ludwig import gradients as PGR  # noqa: E402
from repro_torch.apps.ludwig import kernel as LK  # noqa: E402
from repro_torch.apps.ludwig import lc as PLC  # noqa: E402
from repro_torch.core import TargetConfig, parse_layout  # noqa: E402
from repro_torch.core import Field as PField  # noqa: E402
from repro_torch.kernels.lb_collision import ref as lbref  # noqa: E402
from repro_torch.maths import d3q19  # noqa: E402

TORCH = TargetConfig("torch", device="cpu")
LAT = (8, 8, 8)
# site-local fp32 arithmetic in the same order on both sides: XLA and torch
# may still round a product or a contracted multiply-add differently, so
# rtol 1e-6 with an atol of 1e-6 x the output's largest magnitude (values
# that cancel to near zero keep the absolute error of their terms)
CHUNK_RTOL, CHUNK_ATOL = 1e-6, 1e-6
# the reference's own C1 tolerance for one step (tests/test_ludwig.py)
STEP_RTOL, STEP_ATOL = 3e-5, 1e-7

jstep = jax.jit(JD.step, static_argnums=1)


def _close(got, want, rtol=CHUNK_RTOL, atol=CHUNK_ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


def _chunks(rng, n=256):
    """Inputs at the scales the step sees: q ~ 1e-2, gradients ~ 1e-2."""
    mk = lambda rows, s: (s * rng.normal(size=(rows, n))).astype(np.float32)  # noqa: E731
    return dict(q=mk(5, 0.05), lapq=mk(5, 0.02), h=mk(5, 0.01), dq=mk(15, 0.02),
                w=mk(9, 0.01), adv=mk(5, 0.01), rhs=mk(5, 0.01))


def _both(fn_p, fn_j, arrs, names, **kw):
    got = fn_p(*(torch.from_numpy(arrs[n]) for n in names), **kw)
    want = fn_j(*(jnp.asarray(arrs[n]) for n in names), **kw)
    return got.numpy(), np.asarray(want)


CHUNKS = [
    ("molecular_field", ("q", "lapq"), dict(a0=0.01, gamma=3.0, kappa=0.01)),
    ("free_energy_density", ("q", "dq"), dict(a0=0.01, gamma=3.0, kappa=0.01)),
    ("stress", ("q", "h", "dq"), dict(kappa=0.01, xi=0.7)),
    ("beris_edwards_rhs", ("q", "h", "w"), dict(gamma_rot=0.3, xi=0.7)),
    ("q_update", ("q", "rhs", "adv"), dict(dt=1.0)),
]


@pytest.mark.parametrize("name,args,kw", CHUNKS, ids=[c[0] for c in CHUNKS])
def test_lc_chunks_match_reference(name, args, kw, rng):
    fn = f"{name}_chunk"
    got, want = _both(getattr(PLC, fn), getattr(JLC, fn), _chunks(rng), args, **kw)
    assert got.shape == want.shape
    _close(got, want)


STENCILS = ["grad_central", "laplacian", "divergence", "advective_divergence"]


@pytest.mark.parametrize("name", STENCILS)
@pytest.mark.parametrize("lat", [(4, 6, 8), (1, 3, 2)], ids=str)
def test_gradient_stencils_match_reference(name, lat, rng):
    q = (0.05 * rng.normal(size=(5,) + lat)).astype(np.float32)
    s9 = (0.01 * rng.normal(size=(9,) + lat)).astype(np.float32)
    u = (0.01 * rng.normal(size=(3,) + lat)).astype(np.float32)
    args = {"grad_central": (q,), "laplacian": (q,), "divergence": (s9,),
            "advective_divergence": (q, u)}[name]
    got = getattr(PGR, name)(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(getattr(JGR, name)(*map(jnp.asarray, args)))
    assert got.shape == want.shape
    _close(got, want)


def _graph_inputs(rng, lat):
    mk = lambda c, s: (s * rng.normal(size=(c,) + lat)).astype(np.float32)  # noqa: E731
    return dict(q=mk(5, 0.05), lapq=mk(5, 0.02), dq=mk(15, 0.02), h=mk(5, 0.01),
                w=mk(9, 0.01), adv=mk(5, 0.01),
                dist=(1.0 + 0.1 * rng.normal(size=(19,) + lat)).astype(np.float32),
                force=mk(3, 0.01))


GRAPHS = [
    ("chem_stress_graph", ("q", "lapq", "dq"), ("h", "sigma")),
    ("lc_update_graph", ("q", "h", "w", "adv"), ("q_new",)),
    ("lc_chain_graph", ("q", "lapq", "w", "adv"), ("q_new",)),
    ("lb_step_graph", ("dist", "force"), ("dist2", "u", "rho")),
]


@pytest.mark.parametrize("name,ins,outs", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_ludwig_graphs_match_reference(name, ins, outs, rng):
    lat = (4, 4, 8)
    arrs = _graph_inputs(rng, lat)
    got = getattr(PD, name)(LudwigConfig()).launch(
        {n: PField.from_numpy(n, arrs[n], lat) for n in ins}, config=TORCH, outputs=outs)
    want = getattr(JD, name)(JLudwigConfig()).launch(
        {n: JField.from_numpy(n, arrs[n], lat) for n in ins}, config=JTC("jnp"),
        outputs=outs)
    for o in outs:
        _close(got[o].to_numpy(), want[o].to_numpy(), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("layout", ["soa", "aosoa64"])
def test_init_state_bitwise(layout):
    cfg = LudwigConfig(lattice=LAT, layout=parse_layout(layout), target=TORCH)
    jcfg = JLudwigConfig(lattice=LAT, layout=j_parse_layout(layout))
    s, js = init_state(cfg, seed=3), JD.init_state(jcfg, seed=3)
    for p, j in ((s.dist, js.dist), (s.q, js.q)):
        assert p.layout.name == j.layout.name
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data))


@pytest.fixture(scope="module")
def trajectories():
    """Five steps of the default 8^3 problem in both packages."""
    cfg = LudwigConfig(lattice=LAT, target=TORCH)
    jcfg = JLudwigConfig(lattice=LAT, target=JTC("jnp"))
    s, js = init_state(cfg, seed=0), JD.init_state(jcfg, seed=0)
    out = [(s, js)]
    for _ in range(5):
        s, js = step(s, cfg), jstep(js, jcfg)
        out.append((s, js))
    return cfg, jcfg, out


@pytest.mark.parametrize("nsteps", [1, 5])
def test_step_matches_reference(trajectories, nsteps):
    """Each of one and five steps at the reference's C1 tolerance."""
    _, _, out = trajectories
    s, js = out[nsteps]
    np.testing.assert_allclose(s.q.to_numpy(), np.asarray(js.q.to_numpy()),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(s.dist.to_numpy(), np.asarray(js.dist.to_numpy()),
                               rtol=STEP_RTOL, atol=STEP_ATOL)


def test_diagnostics_match_reference(trajectories):
    cfg, jcfg, out = trajectories
    s, js = out[5]
    d, jd = PD.diagnostics(s, cfg), JD.diagnostics(js, jcfg)
    np.testing.assert_allclose(float(d["mass"]), float(jd["mass"]), rtol=1e-5)
    np.testing.assert_allclose(float(d["free_energy"]), float(jd["free_energy"]), rtol=1e-4)
    np.testing.assert_allclose(d["momentum"].numpy(), np.asarray(jd["momentum"]), atol=2e-6)


def test_step_timed_matches_step(trajectories):
    cfg, _, out = trajectories
    s0 = out[0][0]
    s1, t = PD.step_timed(s0, cfg)
    assert set(t) == {"order_parameter_gradients", "chemical_stress", "lb_step",
                      "velocity_gradients", "advection", "lc_update"}
    assert all(v >= 0 for v in t.values())
    assert torch.equal(s1.q.data, out[1][0].q.data)
    assert torch.equal(s1.dist.data, out[1][0].dist.data)


def test_conservation_and_relaxation():
    """tests/test_ludwig.py::test_conservation_and_relaxation on the port."""
    cfg = LudwigConfig(lattice=LAT, target=TORCH)
    s0 = init_state(cfg, seed=0)
    d0 = PD.diagnostics(s0, cfg)
    s = s0
    for _ in range(20):
        s = step(s, cfg)
    d = PD.diagnostics(s, cfg)
    assert abs(float(d["mass"]) - float(d0["mass"])) < 1e-2
    assert float(d["free_energy"]) <= float(d0["free_energy"]) + 1e-6
    assert np.abs(d["momentum"].numpy()).max() < 1e-4
    assert np.isfinite(s.q.to_numpy()).all()


def test_shear_wave_viscous_decay():
    """u_y(x) = u0 sin(kx) decays at exp(-nu k^2 t), nu = cs^2 (tau - 1/2),
    within 2% (tests/test_ludwig.py)."""
    tau, L, n_steps, u0 = 0.8, 32, 50, 1e-3
    lat = (L, 4, 4)
    nsites = int(np.prod(lat))
    u = np.zeros((3,) + lat, np.float32)
    u[1] = (u0 * np.sin(2 * np.pi * np.arange(L) / L))[:, None, None]
    feq = lbref.equilibrium(torch.ones(nsites), torch.from_numpy(u.reshape(3, -1)))
    cfg = LudwigConfig(lattice=lat, tau=tau, a0=0.0, kappa=0.0, gamma_rot=0.0, xi=0.0,
                       target=TORCH)
    state = LudwigState(
        dist=PField.from_canonical("dist", feq, lat, cfg.layout),
        q=PField.from_canonical("q", torch.zeros((5, nsites)), lat, cfg.layout))
    for _ in range(n_steps):
        state = step(state, cfg)
    _, u_out = lbref.moments(state.dist.canonical())
    uy_out = u_out[1].numpy().reshape(lat)[:, 0, 0]
    amp = 2.0 * np.abs(np.fft.rfft(uy_out)[1]) / L
    nu = d3q19.CS2 * (tau - 0.5)
    k = 2 * np.pi / L
    want = u0 * np.exp(-nu * k * k * n_steps)
    assert abs(amp - want) / want < 0.02, (amp, want)


def test_nematic_transition_direction():
    """gamma < 2.7 relaxes toward isotropic (|Q| down)."""
    cfg = LudwigConfig(lattice=LAT, gamma=2.0, target=TORCH)
    s = init_state(cfg, seed=1, q_amp=5e-3)
    q_in = float(np.abs(s.q.to_numpy()).mean())
    for _ in range(30):
        s = step(s, cfg)
    assert float(np.abs(s.q.to_numpy()).mean()) < q_in


@pytest.mark.parametrize("layout", ["soa", "aosoa128"])
def test_ludwig_state_crosses_bitwise_and_steps_alike(layout):
    jcfg = JLudwigConfig(lattice=LAT, layout=j_parse_layout(layout), target=JTC("jnp"))
    js = jstep(JD.init_state(jcfg, seed=5), jcfg)
    s = convert.to_ludwig_state(np.asarray(js.dist.data), np.asarray(js.q.data),
                                js.dist.lattice, js.dist.layout.name)
    assert s.dist.layout.name == layout and (s.dist.ncomp, s.q.ncomp) == (19, 5)
    dist, q, lat, name = convert.from_ludwig_state(s)
    np.testing.assert_array_equal(dist, np.asarray(js.dist.data))
    np.testing.assert_array_equal(q, np.asarray(js.q.data))
    assert (lat, name) == (LAT, layout)
    cfg = LudwigConfig(lattice=LAT, layout=s.q.layout, target=TORCH)
    s2, js2 = step(s, cfg), jstep(js, jcfg)
    np.testing.assert_allclose(s2.q.to_numpy(), np.asarray(js2.q.to_numpy()),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(s2.dist.to_numpy(), np.asarray(js2.dist.to_numpy()),
                               rtol=STEP_RTOL, atol=STEP_ATOL)


def test_kernel_wrappers_take_their_plain_version_on_the_cpu(rng):
    a = {k: torch.from_numpy(v) for k, v in _chunks(rng, 64).items()}
    h, sigma = LK.chem_stress_cuda(a["q"], a["lapq"], a["dq"], a0=0.01, gamma=3.0,
                                   kappa_m=0.01, kappa_s=0.02, xi=0.7)
    assert torch.equal(h, PLC.molecular_field_chunk(a["q"], a["lapq"], a0=0.01, gamma=3.0,
                                                    kappa=0.01))
    assert torch.equal(sigma, PLC.stress_chunk(a["q"], h, a["dq"], kappa=0.02, xi=0.7))
    rhs = PLC.beris_edwards_rhs_chunk(a["q"], a["h"], a["w"], gamma_rot=0.3, xi=0.7)
    assert torch.equal(LK.lc_update_cuda(a["q"], a["h"], a["w"], a["adv"], gamma_rot=0.3,
                                         xi=0.7, dt=1.0),
                       PLC.q_update_chunk(a["q"], rhs, a["adv"], dt=1.0))
    assert torch.equal(LK.fed_cuda(a["q"], a["dq"], a0=0.01, gamma=3.0, kappa=0.01),
                       PLC.free_energy_density_chunk(a["q"], a["dq"], a0=0.01, gamma=3.0,
                                                     kappa=0.01))


def test_cuda_engine_and_storage_refused():
    cfg = LudwigConfig(lattice=(4, 4, 8), target=TORCH)
    s = init_state(cfg)
    cuda = dataclasses.replace(cfg, target=TargetConfig("cuda", device="cpu"))
    with pytest.raises(ValueError, match="CUDA device"):
        step(s, cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        PD.diagnostics(s, cuda)
    # the fused LC chain runs K3C, which refuses CPU fields
    with pytest.raises(ValueError, match="CUDA device"):
        PD.lc_chain_graph(cfg).launch(
            {"q": s.q, "lapq": s.q, "w": PField.from_canonical(
                "w", torch.zeros((9, s.q.nsites)), s.q.lattice), "adv": s.q},
            config=cuda.target, outputs=("q_new",))
    budget = dataclasses.replace(cuda, target=TargetConfig("cuda", device="cpu",
                                                           smem_bytes=2048))
    for fn in (step, PD.step_timed):
        # the bf16 LB storage runs on the card alone under the cuda engine,
        # untiled and under a budget that tiles the LB half-step (K9's
        # policy instance)
        for c in (cuda, budget):
            with pytest.raises(ValueError, match="CUDA device"):
                fn(s, dataclasses.replace(c, storage="bfloat16"))
    # a storage the LB kernel has no instance for raises before any device check
    f16 = dataclasses.replace(cuda, storage="float16")
    force = PField.from_canonical("force", torch.zeros((3, s.q.nsites)), s.q.lattice)
    with pytest.raises(ValueError, match="not yet ported"):
        PD.lb_step_graph(f16).launch({"dist": s.dist, "force": force},
                                     config=PD._lb_target(f16), outputs=("dist2", "u"))


def test_default_config_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LudwigConfig(lattice=(2, 2, 4))
    assert cfg.target.engine == "cuda" and cfg.target.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        init_state(cfg)


@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa4"])
def test_k3c_lc_chain_plain_matches_reference(spec, rng):
    """K3C's plain version (the fused LC chain: molecular field, BE rhs and
    Q update) against the reference's ludwig_lc_chain launch on jnp and on
    pallas (interpret) within the chunk tolerance; bitwise the port's graph
    on the torch engine and the K3L pair's plain versions composed."""
    lat = (4, 4, 8)
    n = int(np.prod(lat))
    arrs = _chunks(rng, n)
    names = ("q", "lapq", "w", "adv")
    lay, jlay = parse_layout(spec), j_parse_layout(spec)
    cfg, jcfg = LudwigConfig(lattice=lat), JLudwigConfig(lattice=lat)
    kw = dict(a0=cfg.a0, gamma=cfg.gamma, kappa=cfg.kappa, gamma_rot=cfg.gamma_rot, xi=cfg.xi,
              dt=cfg.dt)
    phys = {k: lay.pack(torch.from_numpy(arrs[k])) for k in names}
    lays = {**{k: lay for k in names}, "q_new": lay}
    got = LK.lc_chain_cuda(*(phys[k] for k in names), layouts=lays, **kw)
    assert LK.LC_CHAIN.launches == 0
    got_c = lay.unpack(got).numpy()
    for engine in ("jnp", "pallas"):
        jout = JD.lc_chain_graph(jcfg).launch(
            {k: JField.from_numpy(k, arrs[k].reshape((-1,) + lat), lat, jlay) for k in names},
            config=JTC(engine), outputs=("q_new",))["q_new"]
        _close(got_c, np.asarray(jout.to_numpy()).reshape(5, -1))
    g = PD.lc_chain_graph(cfg).launch(
        {k: PField.from_canonical(k, torch.from_numpy(arrs[k]), lat, lay) for k in names},
        config=TORCH, outputs=("q_new",))["q_new"]
    assert torch.equal(g.data, got)
    h, _ = LK.chem_stress_plain(phys["q"], phys["lapq"], lay.pack(torch.zeros((15, n))),
                                a0=cfg.a0, gamma=cfg.gamma, kappa_m=cfg.kappa, kappa_s=cfg.kappa,
                                xi=cfg.xi, layouts={"q": lay, "lapq": lay, "dq": lay, "h": lay,
                                                    "sigma": lay})
    pair = LK.lc_update_plain(phys["q"], h, phys["w"], phys["adv"], gamma_rot=cfg.gamma_rot,
                              xi=cfg.xi, dt=cfg.dt,
                              layouts={"q": lay, "h": lay, "w": lay, "adv": lay, "q_new": lay})
    assert torch.equal(pair, got)
