"""Hierarchical YAML configuration system (the port's own copy).

Same behaviour as the JAX package's ``config.py``, kept as a separate copy
so the PyTorch package imports nothing of it. Contract:

  * attribute-style access on nested nodes (``cfg.TRAINER.LR``),
  * ``_BASE_`` file inheritance resolved relative to the config file
    (fvcore ``load_yaml_with_base`` semantics; child keys win),
  * ``merge_from_list`` for ``KEY.SUBKEY value`` CLI override pairs; unknown
    keys raise unless listed in :data:`EXTENSION_KEYS`,
  * ``setup_cfg`` / ``setup_cfg_manual`` / ``load_cfg`` read
    ``configs/{name}.yaml`` — the same files the JAX package reads.

YAML is loaded safely (a ``yaml.SafeLoader`` subclass) with YAML-1.2-style
float resolution so a bare ``1e-4`` parses as float (see ``_ConfigLoader``).
"""

from __future__ import annotations

import ast
import copy
import re
from pathlib import Path

import yaml

BASE_KEY = "_BASE_"
_SCI_NOTATION = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)[eE][+-]?\d+$")

# Knobs beyond the reference's config surface. CLI overrides may set these
# even though no shipped YAML declares them; every other unknown key is
# rejected like the reference's yacs does. The set is the JAX package's, so
# one override list drives both packages. Each key works, raises, or is
# printed as a declared no-op when the trainer starts
# (trainers.declare_knobs); none is accepted silently.
EXTENSION_KEYS = frozenset({
    "MODEL.BN_AXIS_NAME",          # declared no-op: a shard_map axis name
    "MODEL.PACKED_FULLRES",        # declared no-op: a TPU layout trick
    "MODEL.REMAT",                 # blocks.py: checkpointed stages
    "MODEL.SYNC_BN",               # batchnorm.py: sync-BN over the ranks
    "TRAINER.PRECISION",           # factory.py: bf16/fp32 compute dtype
    "TRAINER.GRAD_ACCUM",          # train_lib.py: micro-batches
    "TRAINER.SPATIAL_SHARDS",      # parallel/group.py: the (data, space) grid
    "TRAINER.STEPS_PER_EXECUTION", # trainers.py: steps per window (graph)
    "TRAINER.EVAL_PAD_MULTIPLE",   # evaluation.py: eval bucket granularity
    "TRAINER.PROFILE_DIR",         # trainers.py: torch.profiler trace
    "TRAINER.RESUME_CHECKPOINT",   # trainers.py: resume
    "TRAINER.WEDGE_TIMEOUT",       # trainers.py: the dispatch probe's watchdog
    "DATALOADER.WORKER_TYPE",      # loader.py: thread or process workers
    "DATALOADER.SCENE_CACHE",      # cache.py: packed scene cache on/off
    "DATALOADER.CACHE_DIR",        # cache.py: cache location override
    "DATALOADER.CACHE_DTYPE",      # cache.py: packed imagery dtype
})


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader + YAML-1.2-style float resolution: a BARE ``1e-4`` parses
    as float (PyYAML's 1.1 regex demands a dot and a signed exponent, so it
    would stay a string — the reference relies on fvcore coercing it), while
    a QUOTED "7E2" remains the string the user wrote. Resolving at the YAML
    layer is what makes the quoted/bare distinction possible at all —
    post-hoc string coercion cannot see quoting."""


_ConfigLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float", _SCI_NOTATION, list("-+0123456789."))


class CfgNode(dict):
    """A dict with attribute access and recursive merge support."""

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._convert(v)

    @classmethod
    def _convert(cls, value):
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return [cls._convert(v) for v in value]
        return value

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"Config key '{name}' not found. Available: {sorted(self.keys())}"
            ) from None

    def __setattr__(self, name: str, value):
        self[name] = self._convert(value)

    def __delattr__(self, name: str):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode | dict") -> None:
        _merge_into(self, other)

    def merge_from_file(self, cfg_filename: str | Path) -> None:
        loaded = load_yaml_with_base(cfg_filename)
        self.merge_from_other_cfg(loaded)

    def merge_from_list(self, opts: list | None) -> None:
        """Merge ``[KEY, value, KEY, value, ...]`` CLI override pairs.

        Values are parsed with yaml (so ``1e-4`` -> float, ``[1,2]`` -> list,
        ``True`` -> bool); unparseable strings stay strings. Dotted keys
        address nested nodes.

        Unknown keys RAISE, like the reference's yacs ``merge_from_list``
        (it asserts "Non-existent key" regardless of new_allowed) — a
        typo'd override (``TRAINER.LRATE 0.001``) must not silently train
        at the default LR. The one extension over yacs: this framework's
        own knobs (:data:`EXTENSION_KEYS`) are accepted even when the
        loaded config files never mention them.
        """
        if not opts:
            return
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for full_key, raw in zip(opts[0::2], opts[1::2]):
            node = self
            parts = full_key.split(".")
            for i, part in enumerate(parts[:-1]):
                if part not in node:
                    if full_key not in EXTENSION_KEYS:
                        raise KeyError(
                            f"Non-existent config key: {full_key} "
                            f"('{'.'.join(parts[:i + 1])}' is not defined; "
                            f"the reference CLI rejects unknown overrides)")
                    node[part] = CfgNode()
                elif not isinstance(node[part], CfgNode):
                    # a typo'd path like MODEL.TYPE.NAME would otherwise
                    # silently erase the scalar MODEL.TYPE; fail loudly at
                    # the cause (the reference's yacs raises here too)
                    raise KeyError(
                        f"Override key '{full_key}' traverses "
                        f"'{'.'.join(parts[:i + 1])}', which holds the "
                        f"non-mapping value {node[part]!r}")
                node = node[part]
            if parts[-1] not in node and full_key not in EXTENSION_KEYS:
                raise KeyError(
                    f"Non-existent config key: {full_key} (the reference "
                    f"CLI rejects unknown overrides; extension knobs "
                    f"are listed in config.EXTENSION_KEYS)")
            node[parts[-1]] = self._convert(_decode_value(raw))

    # -- utilities ----------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = _plain(v)
        return out

    def dump(self, **kwargs) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True, **kwargs)

    def __reduce__(self):
        # pickle / deepcopy (clone) rebuild the node from plain dicts
        return (CfgNode, (self.to_dict(),))


def _plain(value):
    if isinstance(value, CfgNode):
        return value.to_dict()
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value


def _merge_into(dst: CfgNode, src: dict) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], CfgNode) and isinstance(v, dict):
            _merge_into(dst[k], v)
        else:
            dst[k] = CfgNode._convert(v)


def _decode_value(raw):
    """Decode one CLI override value the way the reference's fvcore/yacs
    stack does (yacs ``_decode_cfg_value``): ``ast.literal_eval``, falling
    back to the raw string. Python literals only — ``True``/``1e-4``/
    ``[8, 16]`` parse, while YAML-1.1 traps (``no``→False, ``010``→octal 8,
    ``1:30``→90, bare dates) stay the string the user typed."""
    if not isinstance(raw, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def load_yaml_with_base(filename: str | Path) -> CfgNode:
    """Load a YAML config, recursively resolving ``_BASE_`` inheritance.

    ``_BASE_`` paths are resolved relative to the file that declares them.
    The child's keys recursively override the base's. Self- or cyclic
    inheritance raises instead of recursing forever (the reference ships a
    config that inherits from itself — baseline_unet_gamma.yaml:1).
    """
    return _load_yaml_with_base(Path(filename), seen=set())


def _load_yaml_with_base(filename: Path, seen: set) -> CfgNode:
    filename = filename.resolve()
    if filename in seen:
        raise ValueError(f"Cyclic _BASE_ inheritance involving {filename}")
    seen = seen | {filename}
    with open(filename) as f:
        raw = yaml.load(f, Loader=_ConfigLoader) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"Config file {filename} must contain a mapping")
    cfg = CfgNode(raw)
    base_ref = cfg.pop(BASE_KEY, None)
    if base_ref is None:
        return cfg
    base_path = Path(base_ref).expanduser()  # fvcore expands a leading '~'
    if not base_path.is_absolute():
        base_path = filename.parent / base_path
    base_cfg = _load_yaml_with_base(base_path, seen)
    _merge_into(base_cfg, cfg)
    return base_cfg


# ---------------------------------------------------------------------------
# Entry points (reference: experiment_manager.py:38-90)
# ---------------------------------------------------------------------------

def new_config() -> CfgNode:
    """Create an empty config with the reference's top-level namespaces
    (experiment_manager.py:44-56). Note the reference declares AUGMENTATIONS/
    DATASETS (plural) while YAML/configs use AUGMENTATION/DATASET (singular);
    both are accepted since new keys are always allowed."""
    c = CfgNode()
    c.CONFIG_DIR = "config/"
    c.PATHS = CfgNode()
    c.TRAINER = CfgNode()
    c.MODEL = CfgNode()
    c.DATALOADER = CfgNode()
    c.AUGMENTATIONS = CfgNode()
    c.CONSISTENCY_TRAINER = CfgNode()
    c.DATASETS = CfgNode()
    return c.clone()


def config_file_path(config_name: str) -> Path:
    """Locate ``configs/{name}.yaml`` relative to cwd, falling back to the
    repo root (directory containing this package). The reference hardcodes
    the cwd-relative path (experiment_manager.py:61)."""
    candidate = Path.cwd() / "configs" / f"{config_name}.yaml"
    if candidate.exists():
        return candidate
    fallback = Path(__file__).resolve().parent.parent / "configs" / f"{config_name}.yaml"
    if fallback.exists():
        return fallback
    return candidate  # let open() raise with the cwd-relative path


def setup_cfg(args) -> CfgNode:
    """CLI entry: merge config file, then trailing ``opts`` overrides, then
    set NAME and PATHS (reference: experiment_manager.py:59-69)."""
    cfg = new_config()
    cfg.merge_from_file(config_file_path(args.config_file))
    cfg.merge_from_list(args.opts)
    cfg.NAME = args.config_file
    cfg.PATHS.ROOT = str(Path.cwd())
    if not Path(args.output_dir).exists():
        raise FileNotFoundError(f"output dir missing: {args.output_dir}")
    cfg.PATHS.OUTPUT = args.output_dir
    if not Path(args.dataset_dir).exists():
        raise FileNotFoundError(f"dataset dir missing: {args.dataset_dir}")
    cfg.PATHS.DATASET = args.dataset_dir
    return cfg


def setup_cfg_manual(config_name: str, output_dir: Path, dataset_dir: Path) -> CfgNode:
    """Programmatic variant (reference: experiment_manager.py:72-81): the
    config file alone, no overrides, with NAME and PATHS set."""
    cfg = new_config()
    cfg.merge_from_file(config_file_path(config_name))
    cfg.NAME = config_name
    cfg.PATHS.ROOT = str(Path.cwd())
    if not Path(output_dir).exists():
        raise FileNotFoundError(f"output dir missing: {output_dir}")
    cfg.PATHS.OUTPUT = str(output_dir)
    if not Path(dataset_dir).exists():
        raise FileNotFoundError(f"dataset dir missing: {dataset_dir}")
    cfg.PATHS.DATASET = str(dataset_dir)
    return cfg


def load_cfg(config_name: str) -> CfgNode:
    """Load by name without path setup (reference: experiment_manager.py:85-90)."""
    cfg = new_config()
    cfg.merge_from_file(config_file_path(config_name))
    cfg.NAME = config_name
    return cfg
