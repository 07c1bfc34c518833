"""Component registry: the config names of the detection nets and of
TrackNet's advanced architecture.

The YAML schema (`model_config.backbone: CSPBackBone`, ...) and the
`<name.lower()>_config` convention are the JAX package's. The components
the JAX package registers and the port does not hold yet (NOT_PORTED)
raise with a pointer to ROADMAP §A.13.
"""
import inspect
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
    "BiPAN": ComponentSpec(necks.BiPAN, necks.bipan_out_channels),
    "DeconvRepBiPAN": ComponentSpec(necks.DeconvRepBiPAN, necks.deconv_repbipan_out_channels),
    "DeconvBiPAN": ComponentSpec(necks.DeconvBiPAN, necks.deconv_bipan_out_channels),
}

HEADS: Dict[str, ComponentSpec] = {
    "EffiDecHead": ComponentSpec(blocks.EffiDecHead),
}

# The modules TrackNet's advanced architecture chains (two for the encoder,
# two for the decoder). Every entry is built as cls(in_channels, **config)
# and its out_channels is fn(in_channels, **config): the four maps' widths
# (CSPNet's in_channels are the stacked frames' channels, which its widths
# do not depend on). DeconvCSPNet ends the chain with the caller's
# out_channels; its function gives its stages' eight widths.
TRACKNET_MODULES: Dict[str, ComponentSpec] = {
    "CSPNet": ComponentSpec(
        backbones.CSPNet,
        lambda in_channels, **cfg: backbones.cspnet_out_channels(cfg.get("width_multiple", 0.5))),
    "RepBiPAN": NECKS["RepBiPAN"],
    "BiPAN": NECKS["BiPAN"],
    "DeconvRepBiPAN": NECKS["DeconvRepBiPAN"],
    "DeconvBiPAN": NECKS["DeconvBiPAN"],
    "DeconvCSPNet": ComponentSpec(
        backbones.DeconvCSPNet,
        lambda in_channels, **cfg: backbones.deconv_cspnet_out_channels(
            cfg.get("width_multiple", 0.5))),
}

# registered by the JAX package, not ported yet
NOT_PORTED = frozenset({"ResNetBackBone", "BasicHead"})


def takes(cls: Any, name: str) -> bool:
    """Whether cls's constructor has a parameter `name` (`deploy`, `remat`:
    a caller passes them only to the modules that have them)."""
    return name in inspect.signature(cls).parameters


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
