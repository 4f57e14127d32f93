"""Port parity for the MILC Wilson-CG solve: generators, conversion, the
solve against the JAX package, the refusals, and the import boundary."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.apps.milc import MilcConfig as JMilcConfig  # noqa: E402
from repro.apps.milc import fields as JF  # noqa: E402
from repro.apps.milc import init_problem as j_init  # noqa: E402
from repro.apps.milc import solve as j_solve  # noqa: E402
from repro.core import Field as JField  # noqa: E402
from repro.core import parse_layout as j_parse_layout  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps.milc import MilcConfig, init_problem, residual_check, solve  # noqa: E402
from repro_torch.apps.milc import fields as PF  # noqa: E402
from repro_torch.apps.milc.cg import cg, dot, g5, make_fused_normal, make_wilson_op  # noqa: E402
from repro_torch.core import DtypePolicy, TargetConfig  # noqa: E402

TORCH = TargetConfig("torch", device="cpu")
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def solved():
    """The tests/test_milc.py problem, solved by both packages."""
    cfg = MilcConfig(lattice=(4, 4, 4, 8), kappa=0.10, tol=1e-10, max_iter=2000,
                     target=TORCH)
    u, b = init_problem(cfg, seed=0)
    res = solve(cfg, u, b)
    jcfg = JMilcConfig(lattice=(4, 4, 4, 8), kappa=0.10, tol=1e-10, max_iter=2000)
    ju, jb = j_init(jcfg, seed=0)
    return cfg, u, b, res, j_solve(jcfg, ju, jb)


@pytest.mark.parametrize("lat,seed,hot", [((4, 4, 4, 4), 3, 1.0), ((2, 4, 2, 6), 0, 0.6),
                                          ((4, 2, 2, 2), 7, 0.0)])
def test_generators_bitwise(lat, seed, hot):
    np.testing.assert_array_equal(PF.random_su3_gauge(lat, seed=seed, hot=hot),
                                  JF.random_su3_gauge(lat, seed=seed, hot=hot))
    np.testing.assert_array_equal(PF.random_spinor(lat, seed=seed),
                                  JF.random_spinor(lat, seed=seed))
    assert PF.unitarity_violation(PF.random_su3_gauge(lat, seed=seed, hot=hot)) < 1e-5


@pytest.mark.parametrize("spec", ["soa", "aos", "aosoa8"])
def test_convert_round_trip_bitwise(spec, rng):
    lat = (4, 2, 4, 2)
    arr = rng.normal(size=(24,) + lat).astype(np.float32)
    jf = JField.from_numpy("psi", arr, lat, j_parse_layout(spec))
    pf = convert.to_field("psi", np.asarray(jf.data), jf.lattice, jf.layout.name, jf.ncomp)
    assert pf.layout.name == spec and pf.lattice == lat
    np.testing.assert_array_equal(pf.to_numpy(), arr)
    phys, lat2, name, ncomp = convert.from_field(pf)
    np.testing.assert_array_equal(phys, np.asarray(jf.data))
    assert (lat2, name, ncomp) == (lat, spec, 24)
    with pytest.raises(ValueError, match="physical shape"):
        convert.to_field("psi", np.asarray(jf.data), jf.lattice, jf.layout.name, 12)


def test_solve_matches_reference(solved):
    cfg, u, b, res, jres = solved
    assert abs(res.iterations - int(jres.iterations)) <= 1
    x, jx = res.x.to_numpy(), np.asarray(jres.x.to_numpy())
    assert np.linalg.norm(x - jx) / np.linalg.norm(jx) < 1e-5
    assert float(res.residual) < cfg.tol * 10
    assert residual_check(cfg, u, b, res.x) < 1e-3


def test_unfused_cg_matches_fused(solved):
    """cg without apply_a_dot: the operator and <p, Ap> as separate launches."""
    cfg, u, b, res, _ = solved
    _, apply_mdag, apply_normal = make_wilson_op(u, cfg.kappa, TORCH)
    res2 = cg(apply_normal, apply_mdag(b), config=TORCH, tol=cfg.tol, max_iter=cfg.max_iter)
    assert abs(res2.iterations - res.iterations) <= 1
    x, x2 = res.x.to_numpy(), res2.x.to_numpy()
    assert np.linalg.norm(x2 - x) / np.linalg.norm(x) < 1e-5


def test_gamma5_hermiticity_and_involution(solved, rng):
    cfg, u, b, _, _ = solved
    apply_m, apply_mdag, _ = make_wilson_op(u, cfg.kappa, TORCH)
    x = b.with_canonical(torch.from_numpy(
        rng.normal(size=(24, b.nsites)).astype(np.float32)))
    lhs = float(dot(x, apply_m(b), TORCH))
    rhs = float(dot(apply_mdag(x), b, TORCH))
    assert abs(lhs - rhs) < 1e-2 * abs(lhs)
    assert torch.equal(g5(g5(x, TORCH), TORCH).data, x.data)


def test_default_config_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MilcConfig(lattice=(2, 2, 2, 4))
    assert cfg.target.engine == "cuda" and cfg.target.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        init_problem(cfg)


def test_cuda_solve_refuses_cpu_fields_and_unported_options():
    """The cuda solve refuses CPU fields, mixed precision included; the
    refined options run on the torch engine (held to the JAX package in
    test_torch_dtype.py); a policy the cuda kernels have no instance for
    raises before any device check."""
    u, b = init_problem(MilcConfig(lattice=(2, 2, 2, 4), target=TORCH))
    for opt in ({}, dict(storage="bfloat16"), dict(refine_k=10)):
        with pytest.raises(ValueError, match="CUDA device"):
            solve(MilcConfig(lattice=(2, 2, 2, 4), **opt), u, b)
    for opt in (dict(storage="bfloat16"), dict(refine_k=10)):
        cfg = MilcConfig(lattice=(2, 2, 2, 4), kappa=0.1, tol=1e-10, target=TORCH, **opt)
        res = solve(cfg, u, b)
        assert residual_check(cfg, u, b, res.x) < 5e-6 and res.iterations > 0
    f16 = TargetConfig("cuda", device="cpu",
                       dtypes=DtypePolicy(storage="float16", compute="float32"))
    with pytest.raises(ValueError, match="not yet ported"):
        make_fused_normal(u, 0.1, f16)(b)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]\n"
        "assert len(mods) >= 15, mods\n"
        "lm = ['repro_torch.' + m for m in ('configs.base', 'configs.rwkv6_7b', 'tuning',\n"
        "      'kernels.rwkv6_scan.kernel', 'kernels.rwkv6_scan.ops', 'models.rwkv6',\n"
        "      'models.transformer', 'train.serve_step', 'configs.starcoder2_7b',\n"
        "      'configs.granite_3_2b', 'configs.olmo_1b', 'configs.deepseek_67b',\n"
        "      'kernels.flash_attention', 'kernels.flash_attention.kernel',\n"
        "      'kernels.flash_attention.ops', 'kernels.flash_attention.ref',\n"
        "      'models.attention', 'launch', 'launch.serve')]\n"
        "assert set(lm) <= set(mods), set(lm) - set(mods)\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    smoke = (SRC.parent / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from repro." not in smoke
