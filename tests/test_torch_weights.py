"""Weight bridge, checkpoints and deploy transforms of the PyTorch port,
against the JAX package on the same numpy-made weights.

Also holds the helpers the other port tests share (small config, JAX
variables with non-trivial BatchNorm state, tree flattening).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.nn import reparam as jax_reparam
from vision_conglomerate_tpu.tools.torch_port import convert_torch_state_dict
from vision_conglomerate_tpu.train import checkpoint as jax_checkpoint

from vision_conglomerate_torch.models.detection import DetectionNet
from vision_conglomerate_torch.nn import reparam
from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
from vision_conglomerate_torch.train import checkpoint
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

# tests/test_reparam_model.py's small config (canonical RepVGG blocks)
CONFIG = {
    "train_anchors": True,
    "backbone": "CSPBackBone",
    "neck": "RepBiPAN",
    "head": "EffiDecHead",
    "cspbackbone_config": {"width_multiple": 0.25, "depth_multiple": 0.2},
    "repbipan_config": {"width_multiple": 0.25, "depth_multiple": 0.2,
                        "repvgg_branch_act": None},
    "effidechead_config": {"width_multiple": 0.5},
}
SILU_CONFIG = {**CONFIG, "repbipan_config": {**CONFIG["repbipan_config"],
                                            "repvgg_branch_act": "silu"}}
ANCHORS = {
    "sm": [[0.1, 0.1], [0.15, 0.15], [0.2, 0.2]],
    "md": [[0.25, 0.25], [0.3, 0.3], [0.35, 0.35]],
    "lg": [[0.4, 0.4], [0.5, 0.5], [0.6, 0.6]],
}
NUM_CLASSES = 2


def to_numpy(tree):
    """A flax variables tree as nested plain dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def randomize_bn(variables, seed: int):
    """Non-trivial BatchNorm scale/bias/mean/var, drawn with numpy, in
    every BatchNorm_0 of a numpy variables tree (in place)."""
    rng = np.random.default_rng(seed)
    params, stats = flat(variables["params"]), flat(variables.get("batch_stats", {}))
    for path in sorted(stats):
        if path[-1] != "mean":
            continue
        bn = path[:-1]
        n = stats[path].shape
        node_p = variables["params"]
        node_s = variables["batch_stats"]
        for key in bn:
            node_p, node_s = node_p[key], node_s[key]
        node_p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        node_p["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        node_s["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        node_s["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    assert params  # the tree has parameters at all
    return variables


def jax_init(module, x_nhwc: np.ndarray, seed: int = 0, **kwargs):
    """numpy variables of a flax module, BatchNorm state randomized."""
    variables = to_numpy(module.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc), **kwargs))
    if "batch_stats" in variables:
        randomize_bn(variables, seed + 1)
    return variables


def jax_detection_variables(config=CONFIG, seed: int = 0, hw: int = 64):
    model = JaxDetectionNet(num_classes=NUM_CLASSES, config=config, anchors=ANCHORS)
    return jax_init(model, np.zeros((1, hw, hw, 3), np.float32), seed, train=False)


def port_detection_net(config=CONFIG, seed: int = 0, **kwargs) -> DetectionNet:
    """A port DetectionNet with weights and BatchNorm state from a seeded
    torch.Generator."""
    g = torch.Generator().manual_seed(seed)
    net = DetectionNet(NUM_CLASSES, config, anchors=ANCHORS, device="cpu", **kwargs)
    return randomize_batchnorm_(init_weights_(net, g), g).eval()


def assert_trees_equal(a, b, atol=0.0):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_allclose(np.asarray(fa[k]), np.asarray(fb[k]), rtol=0, atol=atol,
                                   err_msg="/".join(k))


@pytest.mark.parametrize("config", [CONFIG, SILU_CONFIG], ids=["canonical", "branch_silu"])
def test_state_dict_roundtrip_through_jax_converter(config):
    """port state_dict -> JAX convert_torch_state_dict -> flax_to_state_dict
    is the identity."""
    sd = port_detection_net(config).state_dict()
    back = flax_to_state_dict(convert_torch_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float() if v.is_floating_point() else v), k


@pytest.mark.parametrize("form", ["train", "deploy"])
def test_jax_initialised_net_loads_into_port(form):
    """Every tensor of a JAX-initialised DetectionNet (train form, or its
    deploy transform) lands in the port unchanged, and the port's own
    converter gives the same tree as the JAX package's."""
    variables = jax_detection_variables()
    deploy = form == "deploy"
    if deploy:
        dp, ds = jax_reparam.deploy_transform(variables["params"], variables["batch_stats"])
        variables = to_numpy({"params": dp, **({"batch_stats": ds} if ds else {})})
    net = DetectionNet(NUM_CLASSES, CONFIG, deploy=deploy, folded=deploy, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables))
    sd = net.state_dict()
    assert_trees_equal(state_dict_to_flax(sd), variables)
    assert_trees_equal(to_numpy(convert_torch_state_dict(sd)), variables)


@pytest.mark.parametrize("fuse_repvgg", [True, False])
def test_deploy_transform_matches_jax(fuse_repvgg):
    config = CONFIG if fuse_repvgg else SILU_CONFIG
    variables = jax_detection_variables(config, seed=3)
    dp, ds = jax_reparam.deploy_transform(variables["params"], variables["batch_stats"],
                                          fuse_repvgg=fuse_repvgg)
    want = to_numpy({"params": dp, **({"batch_stats": ds} if ds else {})})
    got = state_dict_to_flax(reparam.deploy_transform(flax_to_state_dict(variables),
                                                      fuse_repvgg=fuse_repvgg))
    assert_trees_equal(got, want, atol=1e-5)


def test_reparameterize_params_matches_jax():
    """RepVGG fusion alone: BN stats of the ConvBNorms pass through."""
    variables = jax_detection_variables(seed=5)
    dp, ds = jax_reparam.reparameterize_params(variables["params"], variables["batch_stats"])
    want = to_numpy({"params": dp, "batch_stats": ds})
    got = state_dict_to_flax(reparam.reparameterize_params(flax_to_state_dict(variables)))
    assert_trees_equal(got, want, atol=1e-5)


def test_checkpoints_interchange(tmp_path):
    """A manifest written by either package reads back in the other."""
    variables = jax_detection_variables(seed=7)
    manifest = {"LAST_EPOCH": 3, "NETWORK_PARAMS": variables, "NUM_CLASSES": NUM_CLASSES}
    jax_path = str(tmp_path / "jax" / "DetectionNet.ckpt.tar")
    jax_checkpoint.save_checkpoint(jax_path, manifest)
    got = checkpoint.load_checkpoint(str(tmp_path / "jax"))  # directory -> newest file
    assert got["LAST_EPOCH"] == 3 and got["NUM_CLASSES"] == NUM_CLASSES
    assert_trees_equal(got["NETWORK_PARAMS"], variables)

    port_path = str(tmp_path / "port" / "DetectionNet.ckpt.tar")
    sd = port_detection_net(seed=8).state_dict()
    checkpoint.save_checkpoint(port_path, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                                           "NETWORK_PARAMS": state_dict_to_flax(sd)})
    back = jax_checkpoint.load_checkpoint(port_path)
    assert_trees_equal(back["NETWORK_PARAMS"], to_numpy(convert_torch_state_dict(sd)))
