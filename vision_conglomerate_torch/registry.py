"""Component registry: the config names of the detection nets and of
TrackNet's advanced architecture.

The YAML schema (`model_config.backbone: CSPBackBone`, ...), the
`<name.lower()>_config` convention and the names of each table are the JAX
package's; a name that is not in a table raises KeyError, as there.
"""
import inspect
from typing import Any, Callable, Dict, NamedTuple, Optional

from .nn import backbones, blocks, necks


class ComponentSpec(NamedTuple):
    cls: Any
    # fn(**config) -> out channels (backbones); fn(in_channels, **config) (necks)
    out_channels: Optional[Callable] = None


def _csp_out_channels(**cfg):
    return backbones.cspnet_out_channels(cfg.get("width_multiple", 0.5),
                                         cfg.get("early_min_channels"))


BACKBONES: Dict[str, ComponentSpec] = {
    "CSPBackBone": ComponentSpec(backbones.CSPBackBone, _csp_out_channels),
    "CSPNet": ComponentSpec(backbones.CSPNet, _csp_out_channels),
    "ResNetBackBone": ComponentSpec(
        backbones.ResNetBackBone,
        lambda **cfg: backbones.resnet_out_channels(cfg.get("block", "BasicBlock"))),
}

NECKS: Dict[str, ComponentSpec] = {
    "RepBiPAN": ComponentSpec(necks.RepBiPAN, necks.repbipan_out_channels),
    "BiPAN": ComponentSpec(necks.BiPAN, necks.bipan_out_channels),
    "DeconvRepBiPAN": ComponentSpec(necks.DeconvRepBiPAN, necks.deconv_repbipan_out_channels),
    "DeconvBiPAN": ComponentSpec(necks.DeconvBiPAN, necks.deconv_bipan_out_channels),
}

HEADS: Dict[str, ComponentSpec] = {
    "EffiDecHead": ComponentSpec(blocks.EffiDecHead),
    "BasicHead": ComponentSpec(blocks.BasicHead),
}

# The modules TrackNet's advanced architecture chains (two for the encoder,
# two for the decoder). Every entry is built as cls(in_channels, **config)
# and its out_channels is fn(in_channels, **config): the four maps' widths
# (CSPNet's in_channels are the stacked frames' channels, which its widths
# do not depend on). DeconvCSPNet ends the chain with the caller's
# out_channels; its function gives its stages' eight widths.
TRACKNET_MODULES: Dict[str, ComponentSpec] = {
    "CSPNet": ComponentSpec(
        backbones.CSPNet, lambda in_channels, **cfg: _csp_out_channels(**cfg)),
    "RepBiPAN": NECKS["RepBiPAN"],
    "BiPAN": NECKS["BiPAN"],
    "DeconvRepBiPAN": NECKS["DeconvRepBiPAN"],
    "DeconvBiPAN": NECKS["DeconvBiPAN"],
    "DeconvCSPNet": ComponentSpec(
        backbones.DeconvCSPNet,
        lambda in_channels, **cfg: backbones.deconv_cspnet_out_channels(
            cfg.get("width_multiple", 0.5))),
}

def takes(cls: Any, name: str) -> bool:
    """Whether cls's constructor has a parameter `name` (`deploy`, `remat`,
    `folded`: a caller passes them only to the modules that have them)."""
    return name in inspect.signature(cls).parameters


def component_config(config: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The `<name.lower()>_config` block of a model config."""
    return dict(config.get(name.lower() + "_config", {}) or {})


def resolve(table: Dict[str, ComponentSpec], name: str) -> ComponentSpec:
    if name not in table:
        raise KeyError(f"Unknown component {name!r}; available: {sorted(table)}")
    return table[name]
