"""Driver of the occupancy training cells: the port's
``scripts.train_occ.train_step`` (train-mode forward, occ_loss, backward
with S1b, clipping, AdamW, the MEGVII EMA), one step after another (a
closed loop) over a few distinct batches made in set-up and cycled.

Set-up: the port's ``BEVDetOcc`` of the configuration, the benchmark's
weights from the seed loaded into it, the CLI's ``make_optimizer`` and
``ema_init``; the batches (``traffic.occ``) on the card. The first
``checked_steps`` steps run through the window's own call while the
harness keeps each step's loss, the first gradient as AdamW took it (its
first moment over 1 - beta1) and, after them, the change of every
parameter and of every EMA entry from the initial state. One more step
runs under the op counter (its convolutions' and products' shapes).

The check frees the program and runs ``reference.occ`` from the same
weights over the same batches, and compares by the worst leaf.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import torch

from harness import check as C
from harness.opcount import count
from harness.trace import traced
from reference import occ as ref
from traffic import occ as traffic

BETA1 = 0.9


def port_config(config: Dict, adopt: bool = False):
    """The port's BEVDetOccConfig of the configuration, checked against the
    file field by field; ``adopt`` (CPU tests) takes the file's fields."""
    from presight_tpu_torch.configs.stage3_configs import occ_configs
    from presight_tpu_torch.occupancy import BEVDetOccConfig

    fields = {f.name for f in dataclasses.fields(BEVDetOccConfig)}
    want = {k: v for k, v in config["model"].items() if k in fields}
    if adopt:
        return BEVDetOccConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                  for k, v in want.items()})
    cfg = occ_configs[config["name"]]()
    got = {k: v for k, v in dataclasses.asdict(cfg).items()}
    fix = lambda v: ([fix(x) for x in v] if isinstance(v, (list, tuple))  # noqa: E731
                     else {k: fix(x) for k, x in v.items()} if isinstance(v, dict) else v)
    for key in fields:
        if fix(got[key]) != fix(want.get(key)):
            raise ValueError(f"the port's {config['name']} has {key} = {got[key]!r}; the "
                             f"configuration's file says {want.get(key)!r}")
    return cfg


def ref_config(config: Dict):
    fields = {f.name for f in dataclasses.fields(ref.BEVDetOccConfig)}
    return ref.BEVDetOccConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                  for k, v in config["model"].items() if k in fields})


def state_spec(config: Dict) -> Dict[str, tuple]:
    """Name -> shape of the reference model's state_dict, in order."""
    with torch.device("meta"):
        model = ref.BEVDetOcc(ref_config(config), device="meta", with_prior_fusion=True)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def make_leaf(seed: int, index: int, name: str, shape: tuple, device) -> torch.Tensor:
    """flax's defaults: conv and dense kernels N(0, 1 / fan_in), biases 0,
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1; each
    kernel from its own generator seeded by (seed, index)."""
    if len(shape) >= 2:
        g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % (1 << 63))
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return torch.randn(shape, generator=g, device=device) / fan_in ** 0.5
    ones = name.endswith("running_var") or (name.endswith("weight") and "BatchNorm" in name)
    return (torch.ones if ones else torch.zeros)(shape, device=device)


def weights(seed: int, spec: Dict[str, tuple], device) -> Dict[str, torch.Tensor]:
    return {k: make_leaf(seed, i, k, s, device) for i, (k, s) in enumerate(spec.items())}


def batches(seed: int, config: Dict, count: int, device) -> List[Dict[str, torch.Tensor]]:
    """``count`` distinct batches: frames b*B..b*B+B-1 of the seed's
    stream, each with the rig's geometry."""
    B = config["batch_size"]
    geo = traffic.rig(B, device)
    out = []
    for b in range(count):
        batch = traffic.stack(traffic.frames(seed, b * B, B, config["model"], True, device))
        batch.update({k: geo[k] for k in ref.MODEL_INPUTS if k != "imgs"})
        out.append(batch)
    return out


class Session:
    def __init__(self, cell: Dict, config: Dict, seed: int, device: str = "cuda",
                 adopt: bool = False):
        from presight_tpu_torch.occupancy import BEVDetOcc
        from presight_tpu_torch.scripts import train_occ
        from presight_tpu_torch.utils.ema import ema_init

        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)
        self.opt_cfg = config["optimizer"]
        self.B = config["batch_size"]
        self.spec = state_spec(config)
        self.train_step = train_occ.train_step
        self.model = BEVDetOcc(port_config(config, adopt), device=self.device,
                               with_prior_fusion=True)
        self.model.load_state_dict(weights(seed, self.spec, self.device), strict=True)
        self.optimizer = train_occ.make_optimizer(self.model, self.opt_cfg["lr"],
                                                  self.opt_cfg["weight_decay"])
        self.ema = ema_init(self.model, init_updates=self.opt_cfg["ema_init_updates"])
        self.batches = batches(seed, config, cell["distinct_batches"], self.device)
        self.steps = 0
        self.losses: List[float] = []
        names = {id(p): n for n, p in self.model.named_parameters()}
        for i in range(cell["checked_steps"]):
            self.losses.append(float(self._step()))
            if i == 0:
                # 0 where AdamW holds no state: it took no gradient
                self.first_grad = {
                    names[id(p)]: C.norm(self.optimizer.state[p].get("exp_avg", torch.zeros(1)))
                    / (1.0 - BETA1) for p in self.model.parameters()}
        self.change = self._changes(dict(self.model.named_parameters()))
        self.ema_change = self._changes(self.ema.params)
        self.unit_work = count(self._step)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _step(self):
        loss, self.ema = self.train_step(self.model, self.optimizer, self.ema,
                                         self.batches[self.steps % len(self.batches)],
                                         self.opt_cfg["grad_clip"], self.opt_cfg["ema_decay"])
        self.steps += 1
        return loss

    def _changes(self, state: Dict[str, torch.Tensor]) -> Dict[str, float]:
        out = {}
        with torch.no_grad():
            for i, (k, shape) in enumerate(self.spec.items()):
                if k in state:
                    out[k] = C.norm(state[k] - make_leaf(self.seed, i, k, shape, self.device))
        return out

    def window(self, seconds: float):
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or steps == 0:
            self._step()
            steps += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        return {"occ_train_frames_per_s": steps * self.B / elapsed}, steps, 0

    def trace(self):
        units = self.cell["trace_steps"]

        def run():
            for _ in range(units):
                self._step()

        trace = traced(run)
        work = {k: v * units for k, v in self.unit_work.items()}
        work["model_flops"] = (work["conv_fwd_flops"] + work["conv_bwd_flops"]
                               + work["matmul_flops"])
        work["units"] = units
        return trace, work

    def readings(self) -> Dict:
        return {"losses": self.losses, "first_grad": self.first_grad, "change": self.change,
                "ema_change": self.ema_change}

    def _free(self) -> None:
        del self.model, self.optimizer, self.ema
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        self._free()
        self.want = reference_readings(self)
        return compare(self.readings(), self.want, self.cell["limits"])

    def calibration(self) -> Dict[str, list]:
        """The control (the reference's convolutions and products in TF32)
        and a planted fault (each step over half its batch), each in the
        program's place."""
        self._free()
        want = reference_readings(self)
        limits = self.cell["limits"]
        return {name: compare(reference_readings(self, **kw), want, limits)
                for name, kw in (("control", {"ieee": False}), ("half_batch", {"half": True}))}


def compare(got: Dict, want: Dict, limits: Dict):
    """The worst step's relative loss gap, and the worst leaf's gap of the
    first gradient's norm, of the parameters' change and of the EMA's
    change (leaves whose reference gradient is under a thousandth of the
    median leaf's left out of the changes: they move by round-off alone)."""
    move = C.moving(want["first_grad"])
    stats = {k for k in want["ema_change"] if k not in want["first_grad"]}
    return [("loss_rel_gap", C.loss_gap(got["losses"], want["losses"]), limits["loss_rel_gap"]),
            ("first_grad_leaf_gap", C.worst_leaf_gap(got["first_grad"], want["first_grad"]),
             limits["first_grad_leaf_gap"]),
            ("change_leaf_gap", C.worst_leaf_gap(got["change"], want["change"], move),
             limits["change_leaf_gap"]),
            ("ema_change_leaf_gap", C.worst_leaf_gap(got["ema_change"], want["ema_change"],
                                                     move | stats),
             limits["ema_change_leaf_gap"])]


def reference_readings(session: Session, ieee: bool = True, half: bool = False) -> Dict:
    """The reference's losses, first-gradient norms, and parameter and EMA
    change norms over the checked steps. ``ieee`` False: its convolutions
    and products in TF32 (the control); ``half``: each step over the first
    half of its batch, the mean over that half (a planted fault)."""
    dev = session.device
    model = ref.BEVDetOcc(ref_config(session.config), device=dev, with_prior_fusion=True)
    model.load_state_dict(weights(session.seed, session.spec, dev), strict=True)
    opt = ref.AdamW(list(model.parameters()), session.opt_cfg["lr"],
                    session.opt_cfg["weight_decay"])
    ema = {k: v.detach().clone() for k, v in model.state_dict().items()
           if v.is_floating_point()}
    names = [n for n, _ in model.named_parameters()]
    data = batches(session.seed, session.config, session.cell["distinct_batches"], dev)
    if half:
        n = session.B // 2
        data = [{k: v[:n] for k, v in b.items()} for b in data]
    losses, first = [], {}
    for i in range(session.cell["checked_steps"]):
        losses.append(ref.train_step(model, opt, ema, session.opt_cfg["ema_init_updates"] + i + 1,
                                     data[i % len(data)], session.opt_cfg["grad_clip"],
                                     session.opt_cfg["ema_decay"], ieee=ieee))
        if i == 0:
            first = {n: C.norm(m) / (1.0 - BETA1) for n, m in zip(names, opt.m)}
    change, ema_change = {}, {}
    params = dict(model.named_parameters())
    with torch.no_grad():
        for i, (k, shape) in enumerate(session.spec.items()):
            p0 = make_leaf(session.seed, i, k, shape, dev)
            if k in params:
                change[k] = C.norm(params[k] - p0)
            if k in ema:
                ema_change[k] = C.norm(ema[k] - p0)
    return {"losses": losses, "first_grad": first, "change": change, "ema_change": ema_change}


def setup(cell: Dict, config: Dict, seed: int) -> Session:
    return Session(cell, config, seed)


def window(session: Session, seconds: float):
    return session.window(seconds)


def trace(session: Session):
    return session.trace()
