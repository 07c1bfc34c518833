"""How far bf16 compute moves one train step's gradients from f32, in the
PyTorch port and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python dev/torch_bf16_grad_noise.py [--size 320]

One seeded port DetectionNet at the shipped config (80 classes, Xavier init,
non-trivial BatchNorm state) is bridged to flax variables; 2 seeded noise
images at size x size with 4 boxes each go through one train-mode forward,
the detection loss and its gradient in bf16 and in f32, in each package.
Prints, per package, the loss and 1 - the cosine between the bf16 and f32
gradients: quantiles over parameters and all gradients as one vector. The
conv biases in front of a train-mode BatchNorm (no gradient in exact
arithmetic) and the anchors are left out. A development tool: it imports
both packages; chip_smoke.py holds the card to the CPU's bf16 distance.
"""
import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def one_minus_cos(a, b, names):
    def cos(x, y):
        x, y = x.astype(np.float64).ravel(), y.astype(np.float64).ravel()
        return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    per = np.array([1.0 - cos(a[n], b[n]) for n in names])
    whole = 1.0 - cos(np.concatenate([a[n].ravel() for n in names]),
                      np.concatenate([b[n].ravel() for n in names]))
    return per, whole


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=320)
    size = parser.parse_args().size

    import jax
    import jax.numpy as jnp
    import torch
    from vision_conglomerate_tpu.losses import DetectionLossConfig as JaxLossConfig
    from vision_conglomerate_tpu.losses import detection_loss as jax_loss
    from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
    from vision_conglomerate_torch.models.detection import DetectionNet
    from vision_conglomerate_torch.nn.blocks import ConvBNorm, randomize_batchnorm_
    from vision_conglomerate_torch.nn.initializers import xavier_conv_init
    from vision_conglomerate_torch.train.detection_trainer import TrainDetectionPipeline
    from vision_conglomerate_torch.train.optim import make_optimizer
    from vision_conglomerate_torch.train_det import make_loss_config
    from vision_conglomerate_torch.utils import load_yaml
    from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

    config = load_yaml(os.path.join(REPO, "configs/detection/config.yaml"))
    anchors = load_yaml(os.path.join(REPO, "configs/detection/anchors.yaml"))["anchors"]
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    labels = np.zeros((2, 8, 5), np.float32)
    mask = np.zeros((2, 8), bool)
    for b in range(2):
        for m in range(4):
            w, h = rng.uniform(0.05, 0.4, 2)
            labels[b, m] = [m * 7 % 80, rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), w, h]
            mask[b, m] = True
    g = torch.Generator().manual_seed(0)
    net = DetectionNet(80, config["model_config"], anchors=anchors)
    randomize_batchnorm_(xavier_conv_init(net, g), g)
    state = net.state_dict()
    variables = state_dict_to_flax(state)
    loss_cfg = make_loss_config(config, 80)
    skip = {f"{n}.conv.bias" for n, m in net.named_modules()
            if isinstance(m, ConvBNorm) and m.conv.bias is not None}

    port = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = DetectionNet(80, config["model_config"], anchors=anchors, dtype=dtype)
        model.load_state_dict(state)
        opt, _ = make_optimizer(config["train_config"]["optimizer_config"], model)
        pipe = TrainDetectionPipeline(model, loss_cfg, opt, init_scheme=None)
        model.train()
        loss = pipe.train_step(*map(torch.from_numpy, (imgs, labels, mask)))["aggregate_loss"]
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        sd.update({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
        port[dtype] = float(loss.detach()), {k: v.numpy() for k, v in sd.items()}
    names = [n for n, p in net.named_parameters() if p.requires_grad and n not in skip]

    jax_cfg = JaxLossConfig(**{k: getattr(loss_cfg, k) for k in loss_cfg.__dataclass_fields__})
    ref = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        model = JaxDetectionNet(num_classes=80, config=config["model_config"], anchors=anchors,
                                dtype=dtype)

        def loss_fn(params):
            out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(imgs, jnp.float32) / 255.0, train=True,
                                 mutable=["batch_stats"])
            a = (params["sm_anchors"], params["md_anchors"], params["lg_anchors"])
            return jax_loss(out, jnp.asarray(labels), jnp.asarray(mask), a, jax_cfg)[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))
        tree = {"params": jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), grads),
                "batch_stats": variables["batch_stats"]}
        ref[dtype] = float(loss), {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}

    for pkg, res, (lo, hi) in (("port", port, (torch.bfloat16, torch.float32)),
                               ("jax", ref, (jnp.bfloat16, jnp.float32))):
        per, whole = one_minus_cos(res[lo][1], res[hi][1], names)
        q = np.quantile(per, [0.5, 0.95, 1.0])
        print(f"{pkg}: {size}x{size}, loss bf16 {res[lo][0]:.6f} f32 {res[hi][0]:.6f}; "
              f"1 - cos(bf16 grad, f32 grad) over {len(names)} parameters: median {q[0]:.4f}, "
              f"95% {q[1]:.4f}, max {q[2]:.4f}; all as one vector {whole:.4f}")


if __name__ == "__main__":
    main()
