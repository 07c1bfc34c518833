"""Data-parallel TrackNet training of the PyTorch port against the JAX
package, on the CPU: TrackNet has its own trainer (`train.tracknet_trainer`).

Two gloo ranks (tests/test_torch_ddp.start_ranks, running while the JAX
side does) each take their half of a
global batch of 4 windows for 2 epochs of one Adadelta step (the
warm-restart schedule of tests/test_torch_tracknet_train.py), then score 5
eval windows at global batch 4 (the wrap-padded tail: rank 0 one valid
row, rank 1 none); the JAX pipeline on a 2-device CPU mesh takes the same
steps from the same bridged weights. Held, with that file's tolerances:
the loss of each step (rtol 1e-4, the pmean of the ranks' losses), the
parameters and running statistics after the first step (atol 1e-4 / rtol
1e-3) and after the second (each tensor within half its update's norm of
the JAX one, the conv biases in front of a BatchNorm left out), the eval
loss (rtol 1e-5) and the tp/tn/fp/fn, precision, recall and f1 exactly;
the two ranks' replicas bit for bit.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_ddp import N_RANKS, finish_ranks, start_ranks

OPT_CFG = {"name": "Adadelta", "lr": 0.1, "rho": 0.9, "eps": 1e-6, "weight_decay": 0}
SCHED_CFG = {"name": "CosineAnnealingWarmRestarts", "T_0": 2, "T_mult": 1, "eta_min": 0.07}


class MemDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    @staticmethod
    def collate_fn(batch):
        return tuple(np.stack(a) for a in zip(*batch))


def tracknet_rank(payload_path: str):
    """One rank: the port's TrackNet trainer on its shards; writes
    rank<r>.pkl beside the payload."""
    from vision_conglomerate_torch.data.loader import DataLoader
    from vision_conglomerate_torch.models import TrackNet
    from vision_conglomerate_torch.parallel import mesh
    from vision_conglomerate_torch.train.lr_schedule import make_lr_scheduler
    from vision_conglomerate_torch.train.optim import make_optimizer
    from vision_conglomerate_torch.train.tracknet_trainer import TrainTrackNetPipeline
    from vision_conglomerate_torch.weights import state_dict_to_flax

    with open(payload_path, "rb") as f:
        p = pickle.load(f)
    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed("cpu")
    net = TrackNet(p["config"])
    net.load_state_dict({k: torch.from_numpy(v) for k, v in p["state_dict"].items()})
    optimizer, base_lr = make_optimizer(OPT_CFG, net)
    pipe = TrainTrackNetPipeline(net, optimizer, init_scheme=None,
                                 lr_scheduler=make_lr_scheduler(SCHED_CFG, base_lr))
    out = {"losses": [], "vars": []}
    for batch in p["train"]:
        out["losses"].append(pipe.train(DataLoader(MemDataset(batch), 4, num_workers=1,
                                                   drop_last=True, shard=True)))
        out["vars"].append(state_dict_to_flax({k: v.clone() for k, v in net.state_dict().items()}))
    out["eval"] = pipe.evaluate(DataLoader(MemDataset(p["eval"]), 4, num_workers=1,
                                           pad_last="wrap", shard=True))
    with open(os.path.join(os.path.dirname(payload_path), f"rank{mesh.rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    mesh.shutdown_distributed()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_torch_tracknet_model import CONFIG, port_tracknet
    from tests.test_torch_tracknet_train import MemDataset as Windows
    from tests.test_torch_tracknet_train import jax_pipeline, make_batch
    from tests.test_torch_weights import flat, to_numpy

    from vision_conglomerate_tpu.data.loader import DataLoader as JaxDataLoader
    from vision_conglomerate_tpu.parallel import make_mesh

    from vision_conglomerate_torch.weights import state_dict_to_flax

    tmp = tmp_path_factory.mktemp("ddp_tn")
    net = port_tracknet(seed=21).train()
    state_dict = {k: v.numpy() for k, v in net.state_dict().items()}
    train = [list(zip(*make_batch(4, seed=30 + i, offset=4 * i))) for i in range(2)]
    eval_items = Windows(5, seed=40).items
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(dict(config=CONFIG, state_dict=state_dict, train=train, eval=eval_items), f)
    procs = start_ranks("import test_torch_ddp_tracknet as t; "
                        f"t.tracknet_rank({str(tmp / 'payload.pkl')!r})")
    try:
        variables = state_dict_to_flax(net.state_dict())
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("tests.test_torch_tracknet_train.make_mesh", lambda n=None: make_mesh(N_RANKS))
            pipe = jax_pipeline(variables)
        assert pipe.mesh.devices.size == N_RANKS
        jax_losses, jax_vars = [], []
        for batch in train:
            jax_losses.append(pipe.train(JaxDataLoader(MemDataset(batch), batch_size=4,
                                                       drop_last=True)))
            jax_vars.append({k: np.array(v) for k, v in flat(to_numpy(
                {"params": pipe.state.params, "batch_stats": pipe.state.batch_stats})).items()})
        jax_eval = pipe.evaluate(JaxDataLoader(MemDataset(eval_items), batch_size=4,
                                               pad_last="wrap"))
    finally:
        finish_ranks(procs)
    ranks = []
    for r in range(N_RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(ranks=ranks, start=flat(variables), jax_losses=jax_losses, jax_vars=jax_vars,
                jax_eval=jax_eval)


def test_ddp_losses_match_jax_mesh(runs):
    for rank in runs["ranks"]:
        assert np.isfinite(rank["losses"]).all() and rank["losses"][0] != rank["losses"][1]
        np.testing.assert_allclose(rank["losses"], runs["jax_losses"], rtol=1e-4)


@pytest.mark.parametrize("step", [0, 1])
def test_ddp_params_and_batch_stats_match_jax_mesh(runs, step):
    from tests.test_torch_tracknet_train import pre_bn_bias
    from tests.test_torch_weights import flat

    got, want, start = flat(runs["ranks"][0]["vars"][step]), runs["jax_vars"][step], runs["start"]
    assert sorted(got) == sorted(want)
    for k in want:
        if step == 0:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3,
                                       err_msg="/".join(k))
        elif not pre_bn_bias(k):
            dist = np.linalg.norm(got[k] - want[k])
            assert dist <= 0.5 * np.linalg.norm(want[k] - start[k]), ("/".join(k), dist)
    kernel = ("params", "decoder", "dec_13", "conv", "kernel")
    var = ("batch_stats", "encoder", "enc_0", "norm", "BatchNorm_0", "var")
    assert not np.allclose(got[kernel], start[kernel], atol=1e-4)
    assert not np.allclose(got[var], start[var], atol=1e-4)
    other = flat(runs["ranks"][1]["vars"][step])
    for k in got:
        np.testing.assert_array_equal(got[k], other[k], err_msg="/".join(k))


def test_ddp_eval_of_the_wrap_padded_tail_matches_jax(runs):
    want = runs["jax_eval"]
    for rank in runs["ranks"]:
        got = rank["eval"]
        assert list(got) == list(want)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in ("tp", "tn", "fp", "fn", "precision", "recall", "f1"):
            assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k
        assert got["tp"] + got["tn"] + got["fp"] + got["fn"] == 5
