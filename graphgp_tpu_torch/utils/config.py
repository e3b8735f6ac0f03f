"""One config layer for the library and the CLIs: a dataclass with YAML
loading.

Counterpart of ``graphgp_tpu/utils/config.py``: one dataclass whose fields
cover every CLI; nested YAML sections are flattened, and unknown keys
raise instead of being dropped. ``--config`` folds a YAML file into a
CLI's argparse defaults, so explicit flags still override its values.

PyYAML is imported only when a file is read: nothing else here needs it, and
a machine without it runs every CLI from its flags.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class ExperimentConfig:
    """Shared experiment configuration."""

    # experiment selection (empty: the CLI's single --graph-type is used)
    datasets: List[str] = field(default_factory=list)
    algorithms: List[str] = field(
        default_factory=lambda: ["random_search", "bfs", "grf_thompson"]
    )

    # BO parameters
    iterations: int = 10
    runs: int = 3
    initial_points: int = 100
    batch_size: int = 50
    seeds: List[int] = field(default_factory=list)

    # graph / GRF parameters
    n_nodes: int = 1024
    graph_type: str = "ring"
    walks_per_node: int = 1000
    p_halt: float = 0.1
    max_walk_length: int = 3
    kernel_kind: str = "free"  # 'free' | 'diffusion'

    # training parameters
    learning_rate: float = 0.01
    train_epochs: int = 30
    gp_retrain_interval: int = 300
    cg_tol: float = 1e-2
    cg_max_iters: int = 100
    num_probes: int = 16
    num_pathwise_samples: int = 64

    # directories
    step_matrices_dir: str = "artifacts/step_matrices"
    results_dir: str = "artifacts/results"

    # seeds
    random_walk_seed: int = 42

    def __post_init__(self):
        if len(self.seeds) != self.runs:
            # the reference's convention: seeds 100, 110, 120, ...
            self.seeds = [100 + 10 * i for i in range(self.runs)]
        os.makedirs(self.step_matrices_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)


# YAML section -> dataclass fields. A field may appear at the top level or
# under its section's header.
_SECTIONS = {
    "bo_parameters": [
        "iterations", "runs", "initial_points", "batch_size", "seeds",
    ],
    "grf_parameters": [
        "walks_per_node", "p_halt", "max_walk_length", "kernel_kind",
        "n_nodes", "graph_type",
    ],
    "training_parameters": [
        "learning_rate", "train_epochs", "gp_retrain_interval", "cg_tol",
        "cg_max_iters", "num_probes", "num_pathwise_samples",
    ],
    "directories": {"step_matrices": "step_matrices_dir", "results": "results_dir"},
    "random_seeds": ["random_walk_seed"],
}


def load_config_from_yaml(path: str) -> ExperimentConfig:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the config file {path} needs PyYAML, which is not installed; "
            "pass the settings as flags instead"
        ) from e

    if not os.path.exists(path):
        raise FileNotFoundError(f"configuration file not found: {path}")
    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    known_fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    out: Dict[str, Any] = {}

    for key, value in raw.items():
        if key in _SECTIONS:
            spec = _SECTIONS[key]
            if isinstance(spec, dict):
                for yk, fk in spec.items():
                    if yk in value:
                        out[fk] = value[yk]
            else:
                for fk in spec:
                    if fk in value:
                        out[fk] = value[fk]
            extra = set(value) - set(spec)
            if extra:
                raise ValueError(f"unknown keys {sorted(extra)} in section {key!r}")
        elif key in known_fields:
            out[key] = value
        else:
            raise ValueError(f"unknown config key {key!r}")
    return ExperimentConfig(**out)


def to_dict(cfg: ExperimentConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


# argparse dest -> ExperimentConfig field, where the names differ
_DEST_ALIASES = {
    "cache_dir": "step_matrices_dir",
    "seed": "random_walk_seed",
    "kind": "kernel_kind",
}


def argparse_defaults_from_config(cfg: ExperimentConfig, parser) -> Dict[str, Any]:
    """A loaded config as a CLI's argparse defaults: every dest whose field
    (through ``_DEST_ALIASES``) the config has. CLIs set these before
    parsing, so explicit flags still override the YAML values."""
    out: Dict[str, Any] = {}
    for action in parser._actions:
        dest = action.dest
        name = _DEST_ALIASES.get(dest, dest)
        if hasattr(cfg, name):
            out[dest] = getattr(cfg, name)
    return out


def add_config_flag(parser) -> None:
    parser.add_argument(
        "--config", default=None, metavar="YAML",
        help="YAML ExperimentConfig (needs PyYAML); CLI flags override its values",
    )


def parse_with_config(parser, argv):
    """Two-stage parse: peek at --config, fold it into the defaults, parse
    again. Returns (namespace, config or None)."""
    pre_args, _ = parser.parse_known_args(argv)
    cfg = None
    if getattr(pre_args, "config", None):
        cfg = load_config_from_yaml(pre_args.config)
        parser.set_defaults(**argparse_defaults_from_config(cfg, parser))
    return parser.parse_args(argv), cfg
