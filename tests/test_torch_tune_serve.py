"""The serving CLI under the tuned plan policy (moved out of
tests/test_torch_tune.py, whose other tuner tests it shares no fixture
with but ``tune_env``, so that the driver's per-file test workers share
the tuner tests' time): a populated table leaves every outcome of the
default CLI as it was."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.apps.milc import MilcConfig, init_problem  # noqa: E402
from repro_torch.apps.milc import driver as PMD  # noqa: E402
from repro_torch.core import TargetConfig  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.core import tune  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

TORCH = TargetConfig("torch", device="cpu")


@pytest.fixture()
def tune_env(tmp_path, monkeypatch):
    """An isolated table per test (the variable is the API)."""
    path = tmp_path / "tune_table.json"
    monkeypatch.setenv(tune.ENV_VAR, str(path))
    monkeypatch.delenv(PP.SMEM_ENV, raising=False)
    tune.clear_table_cache()
    tune.reset_stats()
    yield path
    tune.clear_table_cache()


def test_serve_cli_under_the_tuned_policy(tune_env, capsys):
    """The serving CLI under --plan-policy tuned with a populated table: its
    batched launches miss (batched keys carry the batch) and plan by
    default, so every outcome is the default CLI's."""
    cfg = MilcConfig(lattice=(8, 8, 8, 8), target=TORCH)
    u, b = init_problem(cfg, seed=0)
    PMD.tune_solve_graphs(cfg, u, b, iters=1, warmup=0)
    argv = ["--solve", "--engine", "torch", "--device", "cpu", "--requests", "2", "--slots",
            "2", "--steps", "30"]
    serve.main(argv)
    want = capsys.readouterr().out
    tune.reset_stats()
    serve.main(argv + ["--plan-policy", "tuned"])
    got = capsys.readouterr().out
    assert tune.stats()["lookups"] > 0 and tune.stats()["hits"] == 0
    assert got.splitlines()[1:] == want.splitlines()[1:]
