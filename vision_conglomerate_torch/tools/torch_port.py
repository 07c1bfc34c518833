"""Reference (upstream torch) checkpoint -> the port's state_dict, the
counterpart of the JAX package's tools/torch_port.py.

The port's modules carry the reference attribute names and torch's
layouts, so no weight is transposed; the conversion only rewrites the
module paths of a reference `NETWORK_PARAMS` state_dict:

- a numeric segment of an indexed container keeps its dot where the port
  has the same container (`weights.SEQUENCES`: `bottlenecks.0`, `head.0`,
  `conv_1_3_4.0`, ...) and joins its parent elsewhere (`layer1.0` ->
  `layer1_0`);
- TrackNet base's `_enc_modules.N` / `_dec_modules.N` -> `enc_N` / `dec_N`;
- torchvision ResNet's `layerL.B.downsample.0` / `.1` -> `layerL_B.
  downsample_conv` / `downsample_bn`.

A transpose conv's weight is torch's (I, O, kh, kw) in both, so the port
computes what the reference computes; the JAX package's converter maps it
to flax without the spatial flip its ConvTranspose needs (ROADMAP §C), so
there the two differ. A reference checkpoint holds branch-activated RepVGG
blocks: its config keeps `repvgg_branch_act: silu` (the module default).

    python -m vision_conglomerate_torch.tools.torch_port in.pth.tar out.ckpt.tar

writes the checkpoint manifest that the port's and the JAX package's
loaders read.
"""
import argparse
from typing import Any, Dict, List, Tuple, Union

import torch

from ..weights import SEQUENCES, state_dict_to_flax

_RENAMED = {"_enc_modules": "enc", "_dec_modules": "dec"}


def _port_path(parts: List[str], is_bn: bool) -> List[str]:
    out: List[str] = []
    for part in parts:
        if not part.isdigit():
            out.append(part)
        elif out[-1] == "downsample":
            out[-1] = "downsample_bn" if is_bn else "downsample_conv"
        elif out[-1] in SEQUENCES:
            out.append(part)
        else:
            prev = out.pop()
            out.append(f"{_RENAMED.get(prev, prev)}_{part}")
    return out


def convert_reference_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference NETWORK_PARAMS state_dict (tensors or numpy arrays) ->
    the port's state_dict (f32 CPU tensors; integer leaves such as
    `num_batches_tracked` keep their dtype)."""
    modules: Dict[Tuple[str, ...], Dict[str, Any]] = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        modules.setdefault(tuple(parts[:-1]), {})[parts[-1]] = val
    out: Dict[str, torch.Tensor] = {}
    for path, leaves in modules.items():
        prefix = _port_path(list(path), "running_mean" in leaves)
        for leaf, val in leaves.items():
            t = torch.as_tensor(val).detach().cpu()
            out[".".join(prefix + [leaf])] = t.float() if t.is_floating_point() else t
    return out


def load_reference_checkpoint(path: str, config: Dict[str, Any], task: str = "detection"
                              ) -> Tuple[torch.nn.Module, Union[int, None]]:
    """Read a reference `.pth.tar` manifest (`NETWORK_PARAMS`,
    `NUM_CLASSES`, ...) and return (the port's train-form net of `task`
    ("detection", "segmentation" or "tracknet") at the full `config`,
    holding its weights, in eval mode on the CPU, NUM_CLASSES). Unpickling
    runs code: load only checkpoints from a source you trust."""
    from ..models import DetectionNet, SegmentationNet, TrackNet

    manifest = torch.load(path, map_location="cpu", weights_only=False)
    num_classes = manifest.get("NUM_CLASSES")
    mc = config["model_config"]
    if task == "tracknet":
        img_cfg = config.get("train_config", {}).get("img_config", {})
        net = TrackNet(mc, in_channels=3 * int(img_cfg.get("num_stacks", 3)))
    else:
        cls = SegmentationNet if task == "segmentation" else DetectionNet
        net = cls(int(num_classes or 0), mc, num_keypoints=mc.get("num_keypoints"))
    net.load_state_dict(convert_reference_state_dict(manifest["NETWORK_PARAMS"]))
    return net.eval(), num_classes


def main(argv=None):
    from ..train.checkpoint import save_checkpoint

    parser = argparse.ArgumentParser(description="reference checkpoint -> port checkpoint")
    parser.add_argument("input", help="reference .pth.tar checkpoint")
    parser.add_argument("output", help="output .ckpt.tar path")
    args = parser.parse_args(argv)
    manifest = torch.load(args.input, map_location="cpu", weights_only=False)
    out = {"LAST_EPOCH": manifest.get("LAST_EPOCH", 0),
           "NETWORK_PARAMS": state_dict_to_flax(
               convert_reference_state_dict(manifest["NETWORK_PARAMS"]))}
    for key in ("NUM_CLASSES", "METRICS"):
        if key in manifest:
            out[key] = manifest[key]
    save_checkpoint(args.output, out)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
