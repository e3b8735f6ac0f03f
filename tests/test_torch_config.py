"""``utils/config`` (YAML → ``ExperimentConfig`` → argparse defaults) and
``utils/checkpoint`` against the JAX package, ``--config`` in every port CLI,
the BO sweep's error rows and the ``run_all`` orchestrator on the CPU.

The YAML files are written to ``tmp_path`` (the repository ships none). A
CLI's namespace is taken where it is parsed: ``build_parser`` in the port,
``utils.config.parse_with_config`` patched in the JAX package, whose CLIs
build their parser inside ``main``.
"""
import csv
import sys

import numpy as np
import pytest
import torch

from graphgp_tpu_torch.cli import ablation, bo, classification, regression, run_all, scaling, wind
from graphgp_tpu_torch.utils import checkpoint as tckpt
from graphgp_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work on one intra-op thread: its ops are small, and
    beside other test processes threads that wait by spinning make them many
    times slower (the thread count is restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CLIS = {
    "bo": bo, "scaling": scaling, "ablation": ablation, "regression": regression,
    "run_all": run_all, "wind": wind, "classification": classification,
}
# dests one package has and the other has not: the port's device flag; the
# JAX package's platform switch
PORT_ONLY = {"device"}
JAX_ONLY = {"force_cpu"}


def _yaml(tmp_path, body: str) -> str:
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "exp.yaml"
    path.write_text(
        body
        + "directories:\n"
        + f"  results: {tmp_path / 'results'}\n"
        + f"  step_matrices: {tmp_path / 'cache'}\n"
    )
    return str(path)


FULL = (
    "datasets: [circle, grid]\n"
    "algorithms: [random_search, bfs]\n"
    "bo_parameters:\n"
    "  iterations: 4\n"
    "  runs: 2\n"
    "  initial_points: 5\n"
    "  batch_size: 2\n"
    "grf_parameters:\n"
    "  n_nodes: 64\n"
    "  graph_type: circle\n"
    "  walks_per_node: 20\n"
    "  p_halt: 0.2\n"
    "  max_walk_length: 3\n"
    "  kernel_kind: diffusion\n"
    "training_parameters:\n"
    "  learning_rate: 0.05\n"
    "  train_epochs: 7\n"
    "  gp_retrain_interval: 11\n"
    "  cg_tol: 0.001\n"
    "  cg_max_iters: 50\n"
    "  num_probes: 8\n"
    "  num_pathwise_samples: 9\n"
    "random_seeds:\n"
    "  random_walk_seed: 7\n"
)


def test_yaml_config_equals_jax_field_by_field(tmp_path):
    from graphgp_tpu.utils import config as jconfig

    path = _yaml(tmp_path, FULL + "seeds: [3, 5]\n")
    ours, ref = tconfig.load_config_from_yaml(path), jconfig.load_config_from_yaml(path)
    assert tconfig.to_dict(ours) == jconfig.to_dict(ref)
    assert ours.seeds == [3, 5] and ours.random_walk_seed == 7 and ours.cg_tol == 0.001
    assert (tmp_path / "results").is_dir() and (tmp_path / "cache").is_dir()


def test_default_seeds_follow_runs(tmp_path):
    from graphgp_tpu.utils import config as jconfig

    path = _yaml(tmp_path, "bo_parameters:\n  runs: 4\n")
    ours, ref = tconfig.load_config_from_yaml(path), jconfig.load_config_from_yaml(path)
    assert ours.seeds == ref.seeds == [100, 110, 120, 130]


@pytest.mark.parametrize("body,match", [
    ("no_such_key: 1\n", "unknown config key"),
    ("bo_parameters:\n  iterations: 2\n  nope: 3\n", "unknown keys"),
    ("directories:\n  logs: x\n", "unknown keys"),
], ids=["top-level", "in-a-section", "in-directories"])
def test_unknown_keys_raise_in_both(tmp_path, body, match):
    from graphgp_tpu.utils import config as jconfig

    path = tmp_path / "bad.yaml"
    path.write_text(body)
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match=match):
            mod.load_config_from_yaml(str(path))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tconfig.load_config_from_yaml(str(tmp_path / "absent.yaml"))


class _Parsed(Exception):
    pass


def _jax_namespace(name, argv, monkeypatch):
    import importlib

    from graphgp_tpu.utils import config as jconfig

    captured = {}
    real = jconfig.parse_with_config

    def capture(parser, argv_):
        captured["ns"] = real(parser, argv_)[0]
        raise _Parsed

    monkeypatch.setattr(jconfig, "parse_with_config", capture)
    with pytest.raises(_Parsed):
        importlib.import_module(f"graphgp_tpu.cli.{name}").main(argv)
    return vars(captured["ns"])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_namespace_equals_jax(name, tmp_path, monkeypatch):
    """The same YAML and argv give the same namespace in both packages; the
    explicit flag overrides the YAML's value."""
    path = _yaml(tmp_path, FULL)
    argv = ["--config", path, "--max-walk-length", "4"]
    ours = vars(tconfig.parse_with_config(CLIS[name].build_parser(), argv)[0])
    ref = _jax_namespace(name, argv, monkeypatch)
    assert set(ours) - set(ref) <= PORT_ONLY and set(ref) - set(ours) <= JAX_ONLY
    assert {k: v for k, v in ours.items() if k not in PORT_ONLY} == \
        {k: v for k, v in ref.items() if k not in JAX_ONLY}
    assert ours["max_walk_length"] == 4 and ours["config"] == path
    if "results_dir" in ours:
        assert ours["results_dir"] == str(tmp_path / "results")


def test_without_config_the_defaults_stand():
    ours, cfg = tconfig.parse_with_config(bo.build_parser(), ["--device", "cpu"])
    assert cfg is None and ours.iterations == 20 and ours.config is None


def test_missing_pyyaml_raises_naming_it(tmp_path, monkeypatch):
    path = _yaml(tmp_path, FULL)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        bo.main(["--config", path, "--device", "cpu"])
    # without --config nothing needs it
    ns, _ = tconfig.parse_with_config(regression.build_parser(), ["--device", "cpu"])
    assert ns.config is None


SWEEP = (
    "datasets: [circle, no_such_dataset, grid]\n"
    "algorithms: [random_search, bfs]\n"
    "bo_parameters:\n"
    "  iterations: 3\n"
    "  runs: 2\n"
    "  initial_points: 5\n"
    "  batch_size: 1\n"
    "grf_parameters:\n"
    "  n_nodes: 64\n"
    "  walks_per_node: 20\n"
    "  max_walk_length: 3\n"
)


def test_bo_yaml_sweep_records_one_error_row_like_jax(tmp_path, monkeypatch, capsys):
    from graphgp_tpu.cli import bo as jbo

    root = tmp_path / "raw"
    root.mkdir()
    monkeypatch.setenv("GRAPHGP_DATA_ROOT", str(root))
    ours = bo.main(["--config", _yaml(tmp_path / "p", SWEEP), "--device", "cpu"])
    assert "1 sweep cell(s) failed; error rows recorded" in capsys.readouterr().out
    ref = jbo.main(["--config", _yaml(tmp_path / "j", SWEEP)])
    for recs in (ours, ref):
        errors = [r for r in recs if "error" in r]
        assert len(errors) == 1 and set(errors[0]) == {"graph_type", "error"}
        assert errors[0]["graph_type"] == "no_such_dataset"
        assert errors[0]["error"].startswith("ValueError: unknown graph type 'no_such_dataset'")

    def cells(recs):
        return sorted((r["graph_type"], r["algorithm"], r["seed"], r["iteration"], r["best_value"])
                      for r in recs if "error" not in r)

    assert cells(ours) == cells(ref)
    assert {c[:2] for c in cells(ours)} == {(g, a) for g in ("circle", "grid")
                                            for a in ("random_search", "bfs")}
    with open(tmp_path / "p" / "results" / "bo.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == len(ours) and "error" in rows[0]


def test_bo_failed_cell_records_a_row_and_the_sweep_goes_on(tmp_path, monkeypatch):
    real = bo.make_algorithm

    def flaky(name, *args, **kwargs):
        if name == "bfs":
            raise RuntimeError("cell failed")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(bo, "make_algorithm", flaky)
    recs = bo.main(["--graph-type", "circle", "--n-nodes", "32", "--algorithms", "bfs",
                    "random_search", "--iterations", "2", "--runs", "2", "--initial-points", "4",
                    "--device", "cpu", "--results-dir", str(tmp_path)])
    errors = [r for r in recs if "error" in r]
    assert [(r["algorithm"], r["seed"]) for r in errors] == [("bfs", 100), ("bfs", 110)]
    assert all(set(r) == {"graph_type", "algorithm", "seed", "error"} for r in errors)
    assert errors[0]["error"] == "RuntimeError: cell failed"
    assert {r["seed"] for r in recs if r.get("algorithm") == "random_search"} == {100, 110}


def test_run_all_writes_the_combined_csv_like_jax(tmp_path):
    from graphgp_tpu.cli import run_all as jrun_all

    argv = ["--graph-types", "circle", "grid", "--n-nodes", "64", "--runs", "1",
            "--iterations", "3", "--algorithms", "random_search", "--initial-points", "5"]
    ours = run_all.main([*argv, "--device", "cpu", "--results-dir", str(tmp_path / "p"),
                         "--cache-dir", str(tmp_path / "p" / "cache")])
    ref = jrun_all.main([*argv, "--results-dir", str(tmp_path / "j"),
                         "--cache-dir", str(tmp_path / "j" / "cache")])
    assert not any("error" in r for r in ours)
    assert {r["graph_type"] for r in ours} == {"circle", "grid"}
    headers = []
    for side in ("p", "j"):
        with open(tmp_path / side / "bo_all_graphs.csv") as fh:
            headers.append(next(csv.reader(fh)))
    assert headers[0] == headers[1]
    assert len(ours) == len(ref)


def test_checkpoint_round_trip_of_svgp_state_and_adam(tmp_path):
    from graphgp_tpu_torch.gp import svgp

    g = torch.Generator().manual_seed(0)
    params = svgp.init_variational("free", 4, 6, 3, generator=g)
    params["q_mu"] = torch.randn((6, 3), generator=g)
    opt = torch.optim.Adam([p.requires_grad_(True) for p in params.values()], lr=0.1)
    sum((p**2).sum() for p in params.values()).backward()
    opt.step()
    state = {"params": {k: v.detach() for k, v in params.items()}, "adam": opt.state_dict(),
             "losses": [torch.tensor(1.5), torch.tensor(0.5)]}
    path = str(tmp_path / "ckpt" / "state.pt")
    tckpt.save_params(path, state)
    back = tckpt.load_params(path)
    for k, v in state["params"].items():
        assert torch.equal(back["params"][k], v)
    assert back["adam"]["param_groups"] == state["adam"]["param_groups"]
    for i, s in state["adam"]["state"].items():
        for k, v in s.items():
            assert torch.equal(back["adam"]["state"][i][k], v)
    fresh = torch.optim.Adam([torch.zeros_like(p) for p in params.values()], lr=0.1)
    fresh.load_state_dict(back["adam"])
    like = {"params": {k: v.double() for k, v in state["params"].items()},
            "adam": state["adam"], "losses": state["losses"]}
    assert tckpt.load_params(path, like=like)["params"]["q_mu"].dtype == torch.float64


def test_checkpoint_reads_the_jax_flat_npz(tmp_path, monkeypatch):
    import jax

    from graphgp_tpu.gp import params as jP
    from graphgp_tpu.utils import checkpoint as jckpt

    p = jP.init_params("free", 4, jax.random.PRNGKey(1))
    path = str(tmp_path / "jax_params")
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)  # the JAX npz path
    jckpt.save_params(path, p)
    for name in (path, path + ".npz"):
        back = tckpt.load_params(name)
        assert set(back) == set(p)
        for k in p:
            np.testing.assert_array_equal(back[k].numpy(), np.asarray(p[k]))
            assert isinstance(back[k], torch.Tensor)


@pytest.mark.parametrize("name", ["run_all", "wind", "classification"])
def test_new_clis_default_to_the_card_and_raise_without_one(name, tmp_path):
    cli = CLIS[name]
    assert cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--results-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        cli.main(["--force-cpu"])  # the JAX flag is --device cpu here
