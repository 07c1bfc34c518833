"""Component registry: the config names of the shipped detection model.

The YAML schema (`model_config.backbone: CSPBackBone`, ...) and the
`<name.lower()>_config` convention are the JAX package's. The port holds
the shipped names only; every other component the JAX package registers
is still to be ported and raises with a pointer to ROADMAP §A.13.
"""
from typing import Any, Callable, Dict, NamedTuple, Optional

from .nn import backbones, blocks, necks


class ComponentSpec(NamedTuple):
    cls: Any
    # fn(**config) -> out channels (backbones); fn(in_channels, **config) (necks)
    out_channels: Optional[Callable] = None


BACKBONES: Dict[str, ComponentSpec] = {
    "CSPBackBone": ComponentSpec(
        backbones.CSPBackBone,
        lambda **cfg: backbones.cspnet_out_channels(cfg.get("width_multiple", 0.5))),
    "CSPNet": ComponentSpec(
        backbones.CSPNet,
        lambda **cfg: backbones.cspnet_out_channels(cfg.get("width_multiple", 0.5))),
}

NECKS: Dict[str, ComponentSpec] = {
    "RepBiPAN": ComponentSpec(necks.RepBiPAN, necks.repbipan_out_channels),
}

HEADS: Dict[str, ComponentSpec] = {
    "EffiDecHead": ComponentSpec(blocks.EffiDecHead),
}

# registered by the JAX package, not ported yet
NOT_PORTED = frozenset({
    "ResNetBackBone", "BiPAN", "DeconvRepBiPAN", "DeconvBiPAN", "DeconvCSPNet", "BasicHead",
})


def component_config(config: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The `<name.lower()>_config` block of a model config."""
    return dict(config.get(name.lower() + "_config", {}) or {})


def resolve(table: Dict[str, ComponentSpec], name: str) -> ComponentSpec:
    if name in table:
        return table[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"component {name!r} is not in the port yet (ROADMAP §A.13); "
            f"ported: {sorted(table)}")
    raise KeyError(f"Unknown component {name!r}; available: {sorted(table)}")
