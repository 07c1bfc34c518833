"""Data-parallel detection training and serving of the PyTorch port
(`parallel.mesh`, `parallel.serving`) against the JAX package, on the CPU.

Two gloo ranks, started as torchrun starts them (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT), each take their half of a global batch of 4
for 2 Adam steps of the port's detection trainer, then one eval pass over
5 images at global batch 4 (the wrap-padded tail gives rank 0 one valid
row and rank 1 none). The JAX pipeline on a 2-device CPU mesh takes the
same steps from the same bridged weights. Held: the parameters and
BatchNorm running statistics after the steps (atol 1e-4 / rtol 1e-3, as
tests/test_torch_train.py's trajectory: Adam at eps 1 turns last-bit
gradient differences into steps of that size), the train metrics and the
weighted eval metrics (rtol 1e-4, atol 1e-6), and the two ranks' replicas
bit for bit. `make_dp_serve` on the two ranks against the plain serve of
the whole batch (the same boxes, scores and classes within f32
rounding), and its ValueError for a batch of 3.

This module imports no JAX at its top: the ranks import it to run
`detection_rank`. The JAX side runs while the ranks do; every rank has a
bounded wait and is killed at its end (`start_ranks`, `finish_ranks`).
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RANK_TIMEOUT = 120  # seconds, for all ranks together
N_RANKS = 2
NUM_CLASSES = 2
LOSS_KW = dict(num_classes=NUM_CLASSES, box_w=0.1, class_w=0.3, label_smoothing=0.001)
# tests/test_torch_train.py's trajectory optimizer (see its note on eps)
OPT_CFG = {"name": "Adam", "lr": 1e-3, "eps": 1.0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(code: str, n: int = N_RANKS, cwd=None):
    """Start `python -c code` as ranks 0..n-1 of one gloo group (torchrun's
    environment variables), in `cwd` (or cwd[r] for rank r); returns the
    processes, for `finish_ranks`."""
    cwds = cwd if isinstance(cwd, (list, tuple)) else [cwd] * n
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(PYTHONPATH=os.pathsep.join([REPO, TESTS]), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", code], cwd=cwds[r],
                             env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def finish_ranks(procs, timeout: float = RANK_TIMEOUT):
    """Wait at most `timeout` seconds for all the ranks; a rank still
    running then is killed and the test fails, as does a rank that failed.
    Returns each rank's output."""
    outs, timed_out = [], False
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if timed_out:
        pytest.fail(f"a rank did not finish within {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def detection_items(n: int, seed: int):
    """In-memory detection samples: 64x64 uint8 images, 1-3 boxes each."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        k = int(rng.integers(1, 4))
        labels = np.concatenate([
            rng.integers(0, NUM_CLASSES, (k, 1)),
            rng.uniform(0.2, 0.8, (k, 2)),
            rng.uniform(0.1, 0.4, (k, 2))], axis=1).astype(np.float32)
        items.append((img, labels))
    return items


class MemDataset:
    """Items with a padding collate (at most 4 labels an image)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    @staticmethod
    def collate_fn(batch):
        imgs, labels = zip(*batch)
        out = np.zeros((len(imgs), 4, 5), np.float32)
        mask = np.zeros((len(imgs), 4), bool)
        for i, lab in enumerate(labels):
            out[i, :len(lab)] = lab
            mask[i, :len(lab)] = True
        return np.stack(imgs), out, mask


def detection_rank(payload_path: str):
    """One rank: the port's detection trainer on its shards, then
    make_dp_serve; writes rank<r>.pkl beside the payload."""
    from vision_conglomerate_torch.data.loader import DataLoader
    from vision_conglomerate_torch.infer.runner import detect
    from vision_conglomerate_torch.losses import DetectionLossConfig
    from vision_conglomerate_torch.models.detection import DetectionNet
    from vision_conglomerate_torch.ops.postprocess import postprocess_detections
    from vision_conglomerate_torch.parallel import make_dp_serve, mesh
    from vision_conglomerate_torch.train.detection_trainer import TrainDetectionPipeline
    from vision_conglomerate_torch.train.optim import make_optimizer
    from vision_conglomerate_torch.weights import state_dict_to_flax

    with open(payload_path, "rb") as f:
        p = pickle.load(f)
    torch.set_num_threads(1)
    dev = mesh.maybe_initialize_distributed("cpu")
    assert dev.type == "cpu" and mesh.world_size() == N_RANKS
    net = DetectionNet(NUM_CLASSES, p["config"], anchors=p["anchors"], device="cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in p["state_dict"].items()})
    optimizer, _ = make_optimizer(OPT_CFG, net)
    pipe = TrainDetectionPipeline(net, DetectionLossConfig(**LOSS_KW), optimizer,
                                  init_scheme=None)
    out = {"train": pipe.train(DataLoader(MemDataset(p["train"]), 4, num_workers=1,
                                          shard=True)),
           "eval": pipe.evaluate(DataLoader(MemDataset(p["eval"]), 4, num_workers=1,
                                            pad_last="wrap", shard=True))}
    out["vars"] = state_dict_to_flax({k: v.clone() for k, v in net.state_dict().items()})

    imgs = np.stack([img for img, _ in p["eval"][:4]]).astype(np.float32) / 255.0

    def serve_fn(batch):
        return postprocess_detections(detect(net.eval(), batch, (64, 64)), NUM_CLASSES,
                                      iou_threshold=0.5, score_threshold=0.0,
                                      max_detections=8)

    with torch.no_grad():
        out["plain"] = serve_fn(torch.from_numpy(imgs))
        out["dp"] = make_dp_serve(serve_fn)(torch.from_numpy(imgs))
    try:
        make_dp_serve(serve_fn)(torch.from_numpy(imgs[:3]))
    except ValueError as e:
        out["indivisible"] = str(e)
    with open(os.path.join(os.path.dirname(payload_path), f"rank{mesh.rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    mesh.shutdown_distributed()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on two gloo ranks and the JAX package on a 2-device mesh,
    from one set of bridged weights."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from vision_conglomerate_tpu.data.loader import DataLoader as JaxDataLoader
    from vision_conglomerate_tpu.losses import DetectionLossConfig as JaxLossConfig
    from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
    from vision_conglomerate_tpu.parallel import make_mesh
    from vision_conglomerate_tpu.train import TrainDetectionPipeline as JaxPipeline
    from vision_conglomerate_tpu.train import make_optimizer as jax_make_optimizer

    from vision_conglomerate_torch.weights import state_dict_to_flax

    from tests.test_torch_weights import ANCHORS, CONFIG, port_detection_net, to_numpy

    tmp = tmp_path_factory.mktemp("ddp_det")
    state_dict = {k: v.numpy() for k, v in port_detection_net(CONFIG, seed=21).state_dict().items()}
    payload = dict(config=CONFIG, anchors=ANCHORS, state_dict=state_dict,
                   train=detection_items(8, seed=5), eval=detection_items(5, seed=6))
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    procs = start_ranks(
        f"import test_torch_ddp; test_torch_ddp.detection_rank({str(tmp / 'payload.pkl')!r})")
    try:
        variables = state_dict_to_flax({k: torch.from_numpy(v) for k, v in state_dict.items()})
        model = JaxDetectionNet(num_classes=NUM_CLASSES, config=CONFIG, anchors=ANCHORS)
        tx, _ = jax_make_optimizer(OPT_CFG)
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        with mock.patch.object(JaxDetectionNet, "init", lambda self, *a, **k: jvars):
            pipe = JaxPipeline(model, JaxLossConfig(**LOSS_KW), tx, mesh=make_mesh(N_RANKS),
                               sample_input_shape=(64, 64, 3), init_scheme="")
        pipe.state = jax.device_put(pipe.state.replace(step=jnp.zeros((), jnp.int32)),
                                    NamedSharding(pipe.mesh, PartitionSpec()))
        jax_train = pipe.train(JaxDataLoader(MemDataset(payload["train"]), batch_size=4))
        jax_eval = pipe.evaluate(JaxDataLoader(MemDataset(payload["eval"]), batch_size=4,
                                               pad_last="wrap"))
        jax_vars = to_numpy({"params": pipe.state.params, "batch_stats": pipe.state.batch_stats})
    finally:
        finish_ranks(procs)
    ranks = []
    for r in range(N_RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(ranks=ranks, variables=variables, jax_train=jax_train, jax_eval=jax_eval,
                jax_vars=jax_vars)


def test_ddp_params_and_batch_stats_match_jax_mesh(runs):
    from tests.test_torch_weights import flat

    got, want, start = (flat(v) for v in (runs["ranks"][0]["vars"], runs["jax_vars"],
                                          runs["variables"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3, err_msg="/".join(k))
    kernel = ("params", "backbone", "conv0", "conv", "kernel")
    var = ("batch_stats", "backbone", "conv0", "norm", "BatchNorm_0", "var")
    assert not np.allclose(got[kernel], start[kernel], atol=1e-4)
    assert not np.allclose(got[var], start[var], atol=1e-4)
    # the replicas are one: the same averaged gradients and statistics
    other = flat(runs["ranks"][1]["vars"])
    for k in got:
        np.testing.assert_array_equal(got[k], other[k], err_msg="/".join(k))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_ddp_metrics_match_jax_mesh(runs, mode):
    want = runs[f"jax_{mode}"]
    for rank in runs["ranks"]:
        got = rank[mode]
        assert sorted(got) == sorted(want)
        for k in want:
            if k != "images_per_sec":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_make_dp_serve_matches_plain_serve(runs):
    for rank in runs["ranks"]:
        plain, dp = rank["plain"], rank["dp"]
        assert type(dp).__name__ == "PostProcessResult"
        assert dp.boxes_xyxy.shape == plain.boxes_xyxy.shape == (4, 8, 4)
        assert int(plain.valid.sum()) > 0
        torch.testing.assert_close(dp.valid, plain.valid, rtol=0, atol=0)
        torch.testing.assert_close(dp.classes, plain.classes, rtol=0, atol=0)
        torch.testing.assert_close(dp.scores, plain.scores, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dp.boxes_xyxy, plain.boxes_xyxy, rtol=1e-5, atol=1e-4)
        assert "divisible" in rank["indivisible"]


def test_make_dp_serve_on_one_process():
    """Without a process group: the serve function on the whole batch, any
    batch size (a world of one divides every batch)."""
    from vision_conglomerate_torch.parallel import make_dp_serve

    serve = make_dp_serve(lambda b: (b * 2, {"n": b.sum(1)}))
    x = torch.arange(6.0).reshape(3, 2)
    doubled, extra = serve(x)
    torch.testing.assert_close(doubled, x * 2)
    torch.testing.assert_close(extra["n"], x.sum(1))


def test_shard_batch_rows_and_raise(monkeypatch):
    from vision_conglomerate_torch.parallel import mesh

    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    monkeypatch.setattr(mesh, "rank", lambda: 2)
    x = np.arange(8 * 3).reshape(8, 3)
    imgs, (rows,) = mesh.shard_batch((torch.from_numpy(x), [x[:, 0]]))
    np.testing.assert_array_equal(imgs.numpy(), x[4:6])
    np.testing.assert_array_equal(rows, [12, 15])
    with pytest.raises(ValueError, match="divisible"):
        mesh.shard_batch(np.zeros((6, 2)))
