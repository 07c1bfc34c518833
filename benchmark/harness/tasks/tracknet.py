"""TrackNet (the port's models/tracknet.py), served and trained.

serve: the deploy form as `infer.tracknet_runner.load_tracknet_model`
builds it (BatchNorm folded by `nn.reparam.deploy_transform`, conv
weights cast to the compute dtype, channel padding in the forward), and
each step is `infer.tracknet_runner.track_batch(model, frames, og_hw)`
with the centroid decode: the per-batch call of `run_tracknet_inference`.
The frame stacks are float32 NHWC, as the runner stages them, made from
the seed as a ring of batches already on the device. The traffic's
`form` says what is served: "bf16" (the default) or "int8", the port's
int8 form (`infer.runner.quantize_model_int8`, calibrated on the ring's
first batch, as `run_tracknet_inference --quantize int8` calibrates on
its first), judged against the int8 scheme written out in plain PyTorch
(reference/int8.py).

train: `train.tracknet_trainer.TrainTrackNetPipeline.train_step` on a
ring of uint8 frame stacks and heatmaps made from the seed, the
optimizer of the configuration built by `train.optim.make_optimizer`
with its lr times the world size, as `train_tracknet --use_ddp` does.
Over several ranks the process group is the port's
(`parallel.mesh.maybe_initialize_distributed`), each rank steps on its
`shard_batch` of each global batch, and `_sync_train_step` all-reduces the
gradients. Set-up takes the first steps through the same call; the
reference follows the first three.

`calibration(cell)` names what benchmark/calibrate.py reads for a cell of
this task: its control, its witness and its faults.
"""
import math
from typing import Any, Dict, List, Optional

import torch

from ...reference.int8 import Int8Net, mark_routes
from ...reference.layers import bf16_convs
from ...reference.tracknet import TrackNetBase, centroid_tracks, heatmap
from ...reference.train import first_steps
from .. import seeded
from ..compare import TRACK_TOL_PX, heatmap_numbers, track_gap, train_look, train_numbers
from ..jobs import (CudaSpans, SetupClock, first_grad_norms, forward_records, rebatch,
                    sample_rows)


def _dims(config):
    tc = config["train_config"]
    w, h = tc["img_config"]["img_wh"]
    return int(h), int(w), 3 * int(tc["img_config"].get("num_stacks", 3))


def _reference(config, seed: int, device, state=None) -> TrackNetBase:
    _, _, cin = _dims(config)
    ref = TrackNetBase(config["model_config"], cin).to(device)
    ref.load_state_dict(seeded.fill_state(ref.state_dict(), seed) if state is None else state)
    return ref


def serve_state(config, seed: int, device, calib: int, int8: bool = False):
    """(state, conv records at batch `calib`): seeded weights with running
    statistics from `calib` seeded frame stacks (seeded.calibrate_batchnorm),
    the same for both sides; `int8`: the records name the int8 form's
    kernels (reference/int8.mark_routes)."""
    h, w, cin = _dims(config)
    x = seeded.frames_f32((calib, h, w, cin), seed, device, seeded.CALIBRATION)
    ref = _reference(config, seed, device)
    return seeded.calibrate_batchnorm(mark_routes(ref) if int8 else ref,
                                      x.permute(0, 3, 1, 2).contiguous())


def _records(config, batch: int, int8: bool = False) -> List[tuple]:
    """Conv records of one forward at `batch`; `int8`: with the int8
    form's kernels named (reference/int8.mark_routes)."""
    h, w, cin = _dims(config)
    with torch.device("meta"):
        ref = TrackNetBase(config["model_config"], cin)
        x = torch.empty(batch, cin, h, w)
    if int8:
        mark_routes(ref)
    return forward_records(ref.eval(), [x])


SERVE_FORMS = ("bf16", "int8")
SERVE_FAULTS = ("half_batch", "stale", "altered")
# the int8 form's control: every activation scale times 4, 6-bit
# activations on the same s8 kernels (PERF.md gives its readings)
INT8_CONTROL_FACTOR = 4
INT8_CONTROL = f"int8_x{INT8_CONTROL_FACTOR}"


def serve_form(traffic) -> str:
    form = traffic.get("form", "bf16")
    if form not in SERVE_FORMS:
        raise ValueError(f"serve form {form!r} is not one of {SERVE_FORMS}")
    return form


def coarsen_activations(model: torch.nn.Module, factor: float) -> None:
    """Multiply the activation scale of every int8 conv of the port's
    model by `factor` (the control of the int8 form)."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "q_xscale"):
                m.q_xscale.mul_(factor)


class Serve:
    def __init__(self, cell, seed: int, device: torch.device, control: Optional[str] = None,
                 fault: Optional[str] = None):
        from vision_conglomerate_torch.infer.runner import quantize_model_int8
        from vision_conglomerate_torch.models.tracknet import TrackNet
        from vision_conglomerate_torch.nn.blocks import cast_conv_weights
        from vision_conglomerate_torch.nn.reparam import deploy_transform

        clock = SetupClock(device)
        t = cell.traffic
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.batch, self.ring = int(t["batch"]), int(t["ring"])
        self.og_hw = tuple(t["og_hw"])
        h, w, cin = _dims(cell.config)
        mc = cell.config["model_config"]
        self.threshold = int(cell.config["train_config"].get("heatmap_threshold", 128))
        self.form = serve_form(t)
        if control not in (None, "int8" if self.form == "bf16" else INT8_CONTROL):
            raise ValueError(f"no control {control!r} for the {self.form} form")
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        self.dtype = dtype
        clock.lap("import")
        self.state, records = serve_state(cell.config, seed, device,
                                          int(t["calibration_rows"]), self.form == "int8")
        clock.lap("weights_and_calibration")
        state = self.state
        model = TrackNet(mc, in_channels=cin, folded=True, dtype=dtype, device=device)
        # on the CPU, as the loaders fold a checkpoint's state
        model.load_state_dict(deploy_transform({k: v.cpu() for k, v in state.items()},
                                               fuse_repvgg=False))
        clock.lap("fold")
        self.frames = seeded.frames_f32((self.ring, self.batch, h, w, cin), seed, device)
        clock.lap("inputs")
        if self.form == "int8" or control == "int8":
            quantize_model_int8(model, self.frames[0].permute(0, 3, 1, 2), inference=True,
                                og_size=self.og_hw)
            if control == INT8_CONTROL:
                coarsen_activations(model, INT8_CONTROL_FACTOR)
        else:
            cast_conv_weights(model, dtype)
        self.model = model.eval()
        self.min_steps = int(t["sample_steps"])
        self.samples = sample_rows(seed, self.min_steps, self.batch, int(t["sample_rows"]))
        self.served: Dict[tuple, torch.Tensor] = {}
        self.tracks: Dict[tuple, torch.Tensor] = {}
        self.records = rebatch(records, self.batch)
        self.items_per_step = self.batch
        self._step = -1
        self._spans = CudaSpans(device)
        self._span_hooks: List = []
        self.model.decoder.register_forward_hook(self._capture)
        clock.lap("cast")
        for i in range(self.ring):  # every shape the window uses
            self._call(self.frames[i])
        self._step = -1
        clock.lap("warm")
        self.setup_parts = clock.parts

    def _capture(self, _module, _inputs, logits):
        rows = [r for s, r in self.samples if s == self._step and r < logits.shape[0]]
        for r in rows:
            self.served[(self._step, r)] = logits[r].argmax(dim=0).to(torch.uint8)

    def _call(self, frames):
        from vision_conglomerate_torch.infer.tracknet_runner import track_batch

        if self.fault == "half_batch":
            half = track_batch(self.model, frames[:self.batch // 2], self.og_hw, self.threshold)
            return torch.cat([torch.as_tensor(half)] * 2).numpy()
        return track_batch(self.model, frames, self.og_hw, self.threshold)

    def step(self, i: int) -> None:
        self._step = i
        self._spans.new_step()
        self._spans.mark("start")
        tracks = self._call(self.frames[i % self.ring])
        self._spans.mark("end")
        if self.fault == "stale" and i > 0:
            tracks = self._last
        if self.fault == "altered":
            tracks = tracks + 1.0
        self._last = tracks
        for s, r in self.samples:
            if s == i:
                self.tracks[(s, r)] = torch.as_tensor(tracks[r])

    def spans(self, on: bool) -> None:
        for h in self._span_hooks:
            h.remove()
        self._span_hooks = []
        self._spans.enable(on)
        if on:
            self._span_hooks = [
                self.model.encoder.register_forward_pre_hook(
                    lambda *_: self._spans.mark("forward")),
                self.model.decoder.register_forward_hook(lambda *_: self._spans.mark("tail"))]

    def span_ms(self) -> Dict[str, List[float]]:
        return {"forward": self._spans.ms("forward", "tail"),
                "tail": self._spans.ms("tail", "end")}

    def release(self) -> None:
        self.model = None

    def check(self, witness: bool = False) -> Dict[str, float]:
        """The numbers; `witness` judges the reference computed in bf16 in the
        program's place instead (its classes and the tracks they decode to).
        The int8 form is judged against the int8 reference; its gap against
        the float32 reference is a note (`heatmap_gap_f32`)."""
        ref = _reference(self.cell.config, self.seed, self.device, self.state).eval()
        judge = ref
        if self.form == "int8":
            judge = Int8Net(ref, self.frames[0].permute(0, 3, 1, 2), self.dtype)
        if witness:  # the convs in bf16, each BatchNorm and ReLU in f32 on their output
            with torch.no_grad(), bf16_convs():
                for s, r in self.samples:
                    x = self.frames[s % self.ring][r:r + 1].permute(0, 3, 1, 2)
                    cls = ref(x)[0].argmax(dim=0).to(torch.uint8)
                    self.served[(s, r)] = cls
                    hm = heatmap(cls[None], self.og_hw)
                    self.tracks[(s, r)] = centroid_tracks(hm.cpu(), self.threshold)[0]
        logits, f32_logits, served, ref_tracks, tracks = [], [], [], [], []
        with torch.no_grad():
            for s, r in self.samples:
                x = self.frames[s % self.ring][r:r + 1].permute(0, 3, 1, 2).float()
                logits.append(judge(x)[0])
                if judge is not ref:
                    f32_logits.append(ref(x)[0])
                cls = self.served.get((s, r))
                served.append(cls)
                tracks.append(self.tracks.get((s, r)))
                if cls is not None:
                    hm = heatmap(cls[None], self.og_hw)
                    ref_tracks.append(centroid_tracks(hm.cpu(), self.threshold)[0])
                else:
                    ref_tracks.append(torch.full((3,), math.nan))
        self.track_gap_px = track_gap(tracks, ref_tracks)
        gap = heatmap_numbers(logits, served)
        numbers = {"heatmap_gap": gap if self.track_gap_px <= TRACK_TOL_PX else math.inf}
        if f32_logits:
            numbers["heatmap_gap_f32"] = heatmap_numbers(f32_logits, served)
        return numbers


class Train:
    def __init__(self, cell, seed: int, device: torch.device, control: Optional[str] = None,
                 fault: Optional[str] = None):
        from vision_conglomerate_torch.models.tracknet import TrackNet
        from vision_conglomerate_torch.parallel.mesh import shard_batch, world_size
        from vision_conglomerate_torch.train.base import resolve_remat_default
        from vision_conglomerate_torch.train.optim import make_optimizer
        from vision_conglomerate_torch.train.tracknet_trainer import TrainTrackNetPipeline

        clock = SetupClock(device)
        t = cell.traffic
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.world = world_size()
        self.global_batch, self.ring = int(t["global_batch"]), int(t["ring"])
        h, w, cin = _dims(cell.config)
        # remat as the train CLIs set it for the global batch
        mc = resolve_remat_default(dict(cell.config["model_config"]), self.global_batch)
        tc = cell.config["train_config"]
        dtype = torch.bfloat16 if mc.get("dtype") == "bfloat16" else torch.float32
        clock.lap("import")
        model = TrackNet(mc, in_channels=cin, dtype=dtype, device=device)
        model.load_state_dict(seeded.fill_state(model.state_dict(), seed))
        opt_cfg = dict(tc["optimizer_config"])
        opt_cfg["lr"] = float(opt_cfg.get("lr", 1.0)) * self.world
        self.opt_cfg = opt_cfg
        optimizer, _ = make_optimizer(opt_cfg, model)
        self.pipeline = TrainTrackNetPipeline(model, optimizer, init_scheme=None)
        if fault == "unchanged":
            optimizer.step = lambda *a, **k: None
        if fault == "no_exchange":
            self.pipeline._sync_train_step = lambda metrics: metrics
        clock.lap("weights_and_optimizer")
        self.frames, self.heat = seeded.tracknet_batches(
            self.ring, self.global_batch, (h, w), cin, seed, device,
            float(tc["img_config"].get("avg_diameter", 5)))
        self.local = [shard_batch((self.frames[k], self.heat[k])) for k in range(self.ring)]
        self.items_per_step = self.global_batch // self.world
        self.records = _records(cell.config, self.items_per_step)
        self._spans = CudaSpans(device)
        self._span_hooks: List = []
        clock.lap("inputs_and_counts")
        names = {id(p): n for n, p in model.named_parameters()}
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        model.train()
        losses = []
        for i in range(3):
            losses.append(self.step(i))
            if i == 0:
                grad = first_grad_norms(optimizer, names)
        change = {n: float((p.detach() - start[n]).double().norm())
                  for n, p in model.named_parameters()}
        self.readings = {"losses": [float(v) for v in losses], "grad": grad, "change": change}
        clock.lap("first_steps")
        for i in range(3, 3 + int(t.get("warm_steps", 0))):
            self.step(i)
        clock.lap("warm")
        self.setup_parts = clock.parts
        self.first_window_step = 3 + int(t.get("warm_steps", 0))

    def step(self, i: int):
        frames, heat = self.local[i % self.ring]
        if self.fault == "half_batch":
            frames, heat = frames[:frames.shape[0] // 2], heat[:heat.shape[0] // 2]
        self._spans.new_step()
        loss = self.pipeline.train_step(frames, heat)
        if self.fault == "altered":
            loss = loss * 1.5
        return loss

    def spans(self, on: bool) -> None:
        for h in self._span_hooks:
            h.remove()
        self._span_hooks = []
        self._spans.enable(on)
        if on:
            opt = self.pipeline.optimizer
            self._span_hooks = [
                opt.register_step_pre_hook(lambda *_: self._spans.mark("opt_start")),
                opt.register_step_post_hook(lambda *_: self._spans.mark("opt_end"))]

    def span_ms(self) -> Dict[str, List[float]]:
        return {"optimizer": self._spans.ms("opt_start", "opt_end")}

    def release(self) -> None:
        self.pipeline = None
        self.local = None

    def check(self) -> Dict[str, float]:
        ref = _reference(self.cell.config, self.seed, self.device)
        batches = [(self.frames[k], self.heat[k]) for k in range(3)]
        r = first_steps(ref, batches, self.opt_cfg, shards=self.world)
        self.look = train_look(self.readings, r)
        return train_numbers(self.readings, r)

    @staticmethod
    def control_numbers(cell, seed: int, device, fault: Optional[str] = None,
                        shards: int = 1, bf16: bool = False) -> Dict[str, float]:
        """The reference put in the program's place, in float8 (the control;
        fault None), with a planted fault, or in bf16 (`bf16`: the witness
        of what bf16 alone reads), against the float32 reference."""
        t = cell.traffic
        h, w, cin = _dims(cell.config)
        tc = cell.config["train_config"]
        frames, heat = seeded.tracknet_batches(3, int(t["global_batch"]), (h, w), cin, seed,
                                               device,
                                               float(tc["img_config"].get("avg_diameter", 5)))
        opt = dict(tc["optimizer_config"])
        opt["lr"] = float(opt.get("lr", 1.0)) * shards
        batches = [(frames[k], heat[k]) for k in range(3)]
        ref = first_steps(_reference(cell.config, seed, device), batches, opt, shards=shards)
        other = first_steps(_reference(cell.config, seed, device), batches, opt, shards=shards,
                            fp8=fault is None and not bf16, bf16=bf16, fault=fault)
        return dict(train_numbers(other, ref), look=train_look(other, ref))


def make_job(mode: str, cell, seed: int, device, **opts):
    return {"serve": Serve, "train": Train}[mode](cell, seed, device, **opts)


def calibration(cell) -> Dict[str, List[tuple]]:
    """What benchmark/calibrate.py reads for a cell: {"control" | "witness"
    | "faults": [(kind, how), ...]}, where `how` is either the options of
    a run of the program (harness/main.run_job) with the control or the
    fault planted in it, or a function (seed, device) -> numbers that puts
    the reference in the program's place.

    serve: the bf16 form's control is the port's own int8 form; the int8
    form's, the int8 form with every activation scale times 4
    (INT8_CONTROL); the witness is the reference computed in bf16 in the
    program's place; the faults are planted in the program (SERVE_FAULTS).
    train: the control is the reference in float8 training, the witness
    the reference in bf16, the faults planted in the reference: half the
    batch, and over several chips the exchange left out. A state left
    unchanged reads 1 and needs no run."""
    if cell.traffic["mode"] == "serve":
        control = "int8" if serve_form(cell.traffic) == "bf16" else INT8_CONTROL
        return {"control": [(f"control_{control}", {"control": control})],
                "witness": [("witness_bf16_reference", {"witness": True})],
                "faults": [(f"fault_{f}", {"fault": f}) for f in SERVE_FAULTS]}
    shards = cell.chips

    def numbers(**kw: Any):
        return lambda seed, device: Train.control_numbers(cell, seed, device, shards=shards,
                                                          **kw)

    faults = ("half_batch", "no_exchange") if shards > 1 else ("half_batch",)
    return {"control": [("control_fp8", numbers())],
            "witness": [("witness_bf16_reference", numbers(bf16=True))],
            "faults": [(f"fault_{f}", numbers(fault=f)) for f in faults]}
