"""``cli/bo.py --isolate`` and ``--cell-timeout`` on the CPU: every
(dataset, algorithm, seed) cell in a child process of its own, retried once
with the same command, its ``bo.csv`` read back; a cell that fails twice is
one error row and the sweep goes on.

The children run with one torch thread (``OMP_NUM_THREADS``), as this
module's in-process sweep does, so both do the same float work: the rows
agree exactly but for each iteration's seconds.
"""
import numpy as np
import pytest
import torch

from graphgp_tpu_torch.cli import bo

SMALL = ["--graph-type", "circle", "--n-nodes", "64", "--iterations", "3",
         "--initial-points", "5", "--walks-per-node", "20", "--max-walk-length", "3",
         "--train-epochs", "3", "--gp-retrain-interval", "2", "--bo-seeds", "100", "110",
         "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _without_seconds(rows):
    return [{k: v for k, v in r.items() if k != "iter_seconds"} for r in rows]


def test_isolated_sweep_gives_the_in_process_rows(tmp_path, capsys):
    """random_search and grf_thompson, 2 seeds, 4 children: the same rows,
    in the same order, as the sweep in this process."""
    argv = SMALL + ["--algorithms", "random_search", "grf_thompson",
                    "--cache-dir", str(tmp_path / "cache")]
    inline = bo.main(argv + ["--results-dir", str(tmp_path / "inline")])
    isolated = bo.main(argv + ["--isolate", "--results-dir", str(tmp_path / "isolated")])
    out = capsys.readouterr().out
    assert out.count("== cell ") == 4 and "[retry]" not in out
    assert not any("error" in r for r in inline + isolated)
    assert len(isolated) == len(inline) == 2 * 2 * 3
    assert _without_seconds(isolated) == _without_seconds(inline)
    assert all(np.isfinite(r["iter_seconds"]) for r in isolated)
    for cell in ("circle_random_search_100", "circle_grf_thompson_110"):
        assert (tmp_path / "isolated" / ".cells" / cell / "bo.csv").exists()
    assert (tmp_path / "isolated" / "bo.csv").exists()


def test_a_cell_past_its_timeout_is_one_error_row_and_the_sweep_goes_on(tmp_path, capsys):
    """The GP cell (16 384 nodes, 1000 walks a node, 20 iterations each
    refitting with 100 epochs: ~60 s on one thread) cannot finish in 12 s:
    it is killed, run once more, killed again, and left as one error row
    naming the timeout; the random-search cell after it (~4 s) runs."""
    records = bo.main(["--graph-type", "grid", "--n-nodes", "16384", "--iterations", "20",
                       "--walks-per-node", "1000", "--train-epochs", "100",
                       "--gp-retrain-interval", "1", "--bo-seeds", "100",
                       "--algorithms", "grf_thompson", "random_search", "--device", "cpu",
                       "--isolate", "--cell-timeout", "12",
                       "--cache-dir", str(tmp_path / "cache"),
                       "--results-dir", str(tmp_path / "r")])
    out = capsys.readouterr().out
    errors = [r for r in records if "error" in r]
    assert len(errors) == 1
    assert errors[0]["algorithm"] == "grf_thompson" and errors[0]["seed"] == 100
    assert "cell rc=timeout" in errors[0]["error"]
    assert "cell timeout after 12s" in errors[0]["error"]
    assert "== cell grid_grf_thompson_100 [retry] ==" in out
    rows = [r for r in records if "error" not in r]
    assert [r["iteration"] for r in rows] == list(range(1, 21))
    assert {r["algorithm"] for r in rows} == {"random_search"}
    assert "1 sweep cell(s) failed; error rows recorded" in out


def test_a_child_with_only_error_rows_is_a_failed_cell(tmp_path, monkeypatch):
    """A child that exits 0 but wrote only error rows (an unknown graph
    type) fails both attempts: one error row carrying the child's error."""
    monkeypatch.setenv("GRAPHGP_DATA_ROOT", str(tmp_path))
    records = bo.main(["--graph-type", "no_such_graph", "--algorithms", "random_search",
                       "--bo-seeds", "100", "--iterations", "2", "--device", "cpu",
                       "--isolate", "--results-dir", str(tmp_path / "r")])
    assert len(records) == 1 and set(records[0]) == {"graph_type", "algorithm", "seed", "error"}
    assert "unknown graph type 'no_such_graph'" in records[0]["error"]
