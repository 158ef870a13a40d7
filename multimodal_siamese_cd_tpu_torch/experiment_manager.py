"""Compatibility facade mirroring the reference module layout.

The reference exposes the config system as ``utils.experiment_manager``
(utils/experiment_manager.py). Here the implementation lives in
:mod:`multimodal_siamese_cd_tpu_torch.config`; this module re-exports it so
user code written against the reference's import style keeps working.
"""

from .config import (  # noqa: F401
    CfgNode,
    load_cfg,
    load_yaml_with_base,
    new_config,
    setup_cfg,
    setup_cfg_manual,
)
