"""Driver of the city-tile NeRF training cells: ``Trainer.train`` of the port,
one step after another (a closed loop).

Set-up: the training set in the port's ``DeviceRayStore``, the port's
``Trainer.in_memory`` over it, the benchmark's weights from the seed copied
into the model, and the run placed at the cell's ``start_step`` as a
resumed run places it: the step counter, the proposal-update schedule
replayed through the steps before it, and the learning-rate schedule at
that step. Adam's moments start at zero, as after importing a checkpoint.
Then the first ``checked_steps`` steps run through the window's own call,
``trainer.train(num_steps=1)``, while the harness keeps what the check
needs: the batches the store gathered, the program's random state before
them, the first microbatch's samples and outputs (a forward hook on the
model), each step's loss, the first gradient as Adam took it (its first
moment over 1 - beta1) and the parameters' change over the steps. Further
steps warm up until a step with and one without the proposal gradient
have run.

The check, once the window has closed and the program's state is freed,
runs ``reference.nerf`` from the same weights over the same batches and
draws and compares the gathered pixels, the losses and, by the worst leaf,
the first gradient's norms and the change's norms; and it evaluates the
reference at the first microbatch's own samples and compares the outputs
there. The sample positions hang on the volume render's last bits (the
inverse-CDF resampling moves them), so the losses carry a jitter of the
program's own; at fixed samples only the arithmetic differs.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Dict, List

import torch

from counts import nerf as counts
from harness import check as C
from harness.log import Phases
from harness.trace import traced
from reference import nerf as ref
from traffic import nerf as traffic

BETA1 = 0.9


def port_config(config: Dict, seed: int, adopt: bool = False):
    """The port's TrainerConfig of the configuration, checked against the
    configuration's file value by value, with the run's seed. ``adopt``
    (the CPU tests' tiny configurations) takes the file's values instead of
    refusing them."""
    from presight_tpu_torch.configs import tile_trainer_config

    t = config["trainer"]
    cfg = tile_trainer_config(config["location"], config["tile"], config["depth"], tpu=False)
    model = dataclasses.asdict(cfg.pipeline.model)
    want = dict(config["model"])
    got = {k: model[k] for k in want}
    got["num_proposal_samples_per_ray"] = list(got["num_proposal_samples_per_ray"])
    got["pulse_width"] = list(got["pulse_width"])
    got["proposal_net_args_list"] = [dict(a) for a in got["proposal_net_args_list"]]
    port_trainer = {"train_num_rays_per_batch": cfg.pipeline.datamanager.train_num_rays_per_batch,
                    "microbatch_rays": cfg.microbatch_rays,
                    "optimizers": {k: {f: (list(v) if isinstance(v, tuple) else v)
                                       for f, v in dataclasses.asdict(o).items()}
                                   for k, o in cfg.optimizers.items()}}
    if adopt:
        fix = lambda v: tuple(fix(x) for x in v) if isinstance(v, list) else v  # noqa: E731
        mc = dataclasses.replace(cfg.pipeline.model, **{k: fix(v) for k, v in want.items()})
        mc = dataclasses.replace(mc, proposal_net_args_list=tuple(
            dict(a) for a in want["proposal_net_args_list"]))
        cfg = dataclasses.replace(
            cfg, microbatch_rays=t["microbatch_rays"],
            pipeline=dataclasses.replace(
                cfg.pipeline, model=mc, datamanager=dataclasses.replace(
                    cfg.pipeline.datamanager,
                    train_num_rays_per_batch=t["train_num_rays_per_batch"])))
        return dataclasses.replace(cfg, seed=seed)
    for key, value in {**got, **port_trainer}.items():
        expected = want.get(key, t.get(key))
        if value != expected:
            raise ValueError(f"the port's {config['name']} has {key} = {value!r}; "
                             f"the configuration's file says {expected!r}")
    return dataclasses.replace(cfg, seed=seed)



class Session:
    def __init__(self, cell: Dict, config: Dict, seed: int, device: str = "cuda",
                 adopt: bool = False):
        from presight_tpu_torch.data.device_store import DeviceRayStore
        from presight_tpu_torch.data.cameras import CameraParams
        from presight_tpu_torch.engine.trainer import Trainer

        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)
        self.model_cfg = config["model"]
        self.trainer_cfg = config["trainer"]
        data = config["assumed"]["training_set"]
        self.E = config["num_experts"]
        self.H, self.W = data["height"], data["width"]
        self.n_images = data["samples"] * 6
        self.rays = self.trainer_cfg["train_num_rays_per_batch"]
        self.start = cell["start_step"]
        tcfg = port_config(config, seed, adopt)
        phase = Phases("set-up")

        self.aabbs, self.cent, c2w = scene(config)
        cams = traffic.cameras(c2w, self.H, self.W, self.device)
        imgs = traffic.images(seed, self.n_images, self.H, self.W, self.model_cfg["semantic_dim"],
                              self.device)
        host = {k: v.cpu().numpy() for k, v in imgs.items()}
        del imgs
        phase("training set made and copied to the host")
        store = DeviceRayStore(host["rgb"], host["sky"], host["depth"], host["features"],
                               device=self.device)
        del host
        phase("DeviceRayStore")
        camera_params = CameraParams(c2w=cams["c2w"], fx=cams["fx"], fy=cams["fy"],
                                     cx=cams["cx"], cy=cams["cy"], video_ids=cams["video_ids"])
        self.trainer = Trainer.in_memory(tcfg, store, camera_params, self.aabbs, self.cent,
                                         num_train_cameras=self.n_images, num_train_videos=1,
                                         device=self.device)
        phase("Trainer.in_memory (the port's own init of the model)")
        self.shapes = ref.param_shapes(self.model_cfg, self.E, self.n_images, 1)
        self._load_weights()
        self._place_at(self.start)
        self.groups = self._groups()
        phase("weights from the seed; placed at the start step")
        self._first_steps(store)
        phase(f"{cell['checked_steps']} checked steps (the kernel build in the first)")
        self._warm_up()
        phase("warm-up")

    # ------------------------------------------------------------ set-up

    def _load_weights(self) -> None:
        mine = traffic.weights(self.seed, self.shapes, self.aabbs, self.cent, self.device)
        port = dict(ref.leaf_paths(self.trainer.model.params()))
        with torch.no_grad():
            for path, w in ref.leaf_paths(mine):
                if port[path].shape != w.shape:
                    raise ValueError(f"leaf {path}: the port's {tuple(port[path].shape)}, "
                                     f"the benchmark's {tuple(w.shape)}")
                port[path].copy_(w)
        self.port_leaves = port

    def _place_at(self, step: int) -> None:
        """The trainer at ``step`` as a resumed run: the counter, the
        proposal-update schedule and the learning rate."""
        t = self.trainer
        t.start_step = t.step = step
        for s in range(step):
            t.update_sched.step_cb(s, t.update_sched.updated(s))
        for name, opt in t.optimizers.items():
            factor = ref.lr_factor(self.trainer_cfg["optimizers"][name], step)
            opt.scheduler.last_epoch = step
            for group in opt.adam.param_groups:
                group["lr"] = group["initial_lr"] * factor
            opt.scheduler._last_lr = [g["lr"] for g in opt.adam.param_groups]

    def _groups(self) -> Dict[str, List[str]]:
        """Each optimizer group's leaf paths."""
        by_id = {id(p): path for path, p in self.port_leaves.items()}
        return {name: [by_id[id(p)] for p in opt.params]
                for name, opt in self.trainer.optimizers.items()}

    def _first_steps(self, store) -> None:
        t = self.trainer
        n = self.cell["checked_steps"]
        self.rng_state = t.generator.get_state()
        gathered: List[Dict[str, torch.Tensor]] = []
        batch_fn = store.batch

        def recording(*args, **kwargs):
            out = batch_fn(*args, **kwargs)
            gathered.append({k: v.cpu() for k, v in out.items()})
            return out

        self.losses: List[float] = []
        store.batch = recording
        hook = t.model.register_forward_hook(self._record_first_forward, with_kwargs=True)
        try:
            for i in range(n):
                t.train(num_steps=1, callback=lambda s, m: self.losses.append(m["total_loss"]))
                if i == 0:
                    self.first_grad = self._adam_grad_norms()
        finally:
            del store.batch
            hook.remove()
        self.batches = gathered
        self.change = self._change_norms()

    def _record_first_forward(self, module, args, kwargs, out) -> None:
        """The first forward's rays, each round's samples and the outputs:
        the first microbatch of the first checked step."""
        if hasattr(self, "field_record"):
            return
        bundle = args[0] if args else kwargs["bundle"]
        self.field_record = field_record(
            bundle.origins, bundle.directions, bundle.camera_indices, bundle.video_ids,
            [{"starts": r.starts, "ends": r.ends} for r in out["ray_samples_list"]], out)

    def _adam_grad_norms(self) -> Dict[str, float]:
        """Each leaf's gradient norm as Adam took it (0 where Adam holds no
        state: it took none)."""
        out = {}
        for name, opt in self.trainer.optimizers.items():
            for p in opt.params:
                m = opt.adam.state[p].get("exp_avg")
                out[self._path(p)] = 0.0 if m is None else C.norm(m / (1.0 - BETA1))
        return out

    def _path(self, p) -> str:
        if not hasattr(self, "_by_id"):
            self._by_id = {id(q): path for path, q in self.port_leaves.items()}
        return self._by_id[id(p)]

    def _change_norms(self) -> Dict[str, float]:
        order = {path: i for i, (path, _) in enumerate(ref.leaf_paths(self.shapes))}
        specs = dict(ref.leaf_paths(self.shapes))
        out = {}
        with torch.no_grad():
            for path in (p for g in self.groups.values() for p in g):
                p0 = traffic.leaf(self.seed, order[path], specs[path], self.device)
                out[path] = C.norm(self.port_leaves[path] - p0)
        return out

    def _warm_up(self) -> None:
        """Steps until one with and one without the proposal gradient have run."""
        updates = ref.proposal_updates(self.model_cfg, self.start + 64)
        ran = {updates[s] for s in range(self.start, self.trainer.step)}
        while len(ran) < 2:
            ran.add(updates[self.trainer.step])
            self.trainer.train(num_steps=1)

    # ------------------------------------------------------------ window

    def window(self, seconds: float):
        t = self.trainer
        ends = [time.perf_counter()]
        while ends[-1] - ends[0] < seconds:
            t.train(num_steps=1)
            ends.append(time.perf_counter())
        step_s = sorted(b - a for a, b in zip(ends, ends[1:]))
        print(f"portbench: window: {len(step_s)} steps, step s min {step_s[0]:.4f} median "
              f"{step_s[len(step_s) // 2]:.4f} max {step_s[-1]:.4f}", file=sys.stderr)
        return ({"train_rays_per_s": len(step_s) * self.rays / (ends[-1] - ends[0])},
                len(step_s), 0)

    def trace(self):
        steps = self.cell["trace_steps"]
        first = []

        def run():
            first.append(self.trainer.step)
            self.trainer.train(num_steps=steps)

        trace = traced(run)
        s0 = first[-1]
        updates = ref.proposal_updates(self.model_cfg, s0 + steps)
        micro = self.trainer_cfg["microbatch_rays"]
        flops = tg_bytes = tg_flops = 0.0
        for s in range(s0, s0 + steps):
            flops += counts.train_step_flops(self.model_cfg, self.rays, updates[s])
            b, f = counts.table_grad_step(self.model_cfg, self.E, self.rays, micro, updates[s])
            tg_bytes, tg_flops = tg_bytes + b, tg_flops + f
        return trace, {"units": steps, "model_flops": flops, "table_grad_bytes": tg_bytes,
                       "table_grad_flops": tg_flops}

    # ------------------------------------------------------------ check

    def readings(self) -> Dict:
        return {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}

    def _free(self) -> None:
        self.trainer.close()  # the data manager's prefetch thread
        del self.trainer, self.port_leaves, self._by_id
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """Free the program, run the reference over the checked steps, and
        compare."""
        self._free()
        want = self.want = reference_readings(self)
        got = dict(self.readings(), field_rel_gap=field_gap(self, self.field_record))
        return compare(got, want, want["batch_max_abs"], self.cell["limits"])

    def calibration(self) -> Dict[str, list]:
        """The control (the reference with TF32 products) and a planted fault
        (each step over half its batch), each in the program's place."""
        self._free()
        want = reference_readings(self)
        limits = self.cell["limits"]
        out = {}
        for name, kw in (("control", {"allow_tf32": True}), ("half_batch", {"half": True})):
            got = reference_readings(self, **kw)
            got["field_rel_gap"] = field_gap(self, got["field_record"])
            out[name] = compare(got, want, 0.0, limits)
        return out


def scene(config: Dict):
    """The configuration's scene: (aabbs, centroids, c2w) of its training set."""
    data = config["assumed"]["training_set"]
    return traffic.scene(config["num_experts"], data["samples"], data["ego_step"],
                         at_centroids=data.get("rigs_at") == "centroids")


def field_record(origins, directions, cam, vid, samples, out) -> Dict:
    """A forward's rays, samples and outputs, on the host."""
    host = lambda t: t.detach().cpu()  # noqa: E731
    return {"origins": host(origins), "directions": host(directions), "cam": host(cam).long(),
            "vid": host(vid).long(),
            "samples": [{k: host(v) for k, v in s.items() if k in ("starts", "ends")}
                        for s in samples],
            "weights_list": [host(w) for w in out["weights_list"]],
            **{k: host(out[k]) for k in ("rgb", "semantics", "accumulation")}}


def field_gap(session: "Session", rec: Dict) -> float:
    """The reference, in float32 from the seed's weights, at a recorded
    forward's own samples: the worst relative gap (the norm of the
    difference over the reference's norm) of each round's weights, the rgb
    and semantics composites and the accumulation."""
    dev = session.device
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        P = traffic.weights(session.seed, session.shapes, session.aabbs, session.cent, dev)
        to = lambda t: t.to(dev)  # noqa: E731
        want = ref.outputs_at(P, session.model_cfg, to(rec["origins"]), to(rec["directions"]),
                              to(rec["cam"]), to(rec["vid"]),
                              [{k: to(v) for k, v in s.items()} for s in rec["samples"]])
        pairs = list(zip(rec["weights_list"], want["weights_list"]))
        pairs += [(rec[k], want[k]) for k in ("rgb", "semantics", "accumulation")]
        return max(C.norm(to(g) - w) / max(C.norm(w), 1e-30) for g, w in pairs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def compare(got: Dict, want: Dict, batch_gap: float, limits: Dict):
    """The compared numbers: the gathered batch's largest gap, the outputs'
    gap at the first microbatch's own samples, the worst step's relative
    loss gap, and the worst leaf's gap of the first gradient's norm and of
    the change's norm (leaves whose reference gradient is under a
    thousandth of the median leaf's left out of the change: they move by
    round-off alone)."""
    grads = want["first_grad"]
    return [("batch_max_abs", batch_gap, limits["batch_max_abs"]),
            ("field_rel_gap", got["field_rel_gap"], limits["field_rel_gap"]),
            ("loss_rel_gap", C.loss_gap(got["losses"], want["losses"]),
             limits["loss_rel_gap"]),
            ("first_grad_leaf_gap", C.worst_leaf_gap(got["first_grad"], grads),
             limits["first_grad_leaf_gap"]),
            ("change_leaf_gap", C.worst_leaf_gap(got["change"], want["change"], C.moving(grads)),
             limits["change_leaf_gap"])]


def reference_readings(session: Session, allow_tf32: bool = False, half: bool = False) -> Dict:
    """The reference's losses, first-gradient norms and change norms over
    the session's checked steps, and the largest gap between what the
    store gathered and the benchmark's own pixels, and the first
    microbatch's rays, samples and outputs (``field_record``). ``allow_tf32``: its
    products in TF32 (the control); ``half``: each step over the first half
    of its batch, the mean over that half (a planted fault)."""
    dev = session.device
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        _, _, c2w = scene(session.config)
        cams = traffic.cameras(c2w, session.H, session.W, dev)
        imgs = traffic.images(session.seed, session.n_images, session.H, session.W,
                              session.model_cfg["semantic_dim"], dev)
        batches, gap = [], 0.0
        for rec in session.batches:
            idx = rec["ray_index"].to(dev).long()
            if len(torch.unique(idx[:, 0] * session.H * session.W + idx[:, 1] * session.W
                                + idx[:, 2])) != len(idx):
                gap = math.inf  # a step's rows must all differ
            keep = len(idx) // 2 if half else len(idx)
            b = {"ray_index": rec["ray_index"][:keep].to(dev)}
            for key in ("rgb", "sky", "features"):
                mine = imgs[key][idx[:, 0], idx[:, 1], idx[:, 2]].float()
                gap = max(gap, float(torch.max(torch.abs(rec[key].to(dev).float() - mine))))
                b[key] = mine[:keep]
            batches.append(b)
        del imgs
        P = traffic.weights(session.seed, session.shapes, session.aabbs, session.cent, dev)
        trainer_cfg = dict(session.trainer_cfg, train_num_rays_per_batch=len(batches[0]["rgb"]))
        gen = torch.Generator(device=dev)
        gen.set_state(session.rng_state)
        first, rec = {}, {}
        losses = ref.train_steps(
            P, session.groups, session.model_cfg, trainer_cfg, cams, batches,
            session.start, gen,
            on_first_grads=lambda g: first.update({p: C.norm(v) for p, v in g.items()}),
            on_first_forward=lambda *a: rec.update(field_record(*a)))
        order = {path: i for i, (path, _) in enumerate(ref.leaf_paths(session.shapes))}
        specs = dict(ref.leaf_paths(session.shapes))
        leaves = dict(ref.leaf_paths(P))
        change = {}
        with torch.no_grad():
            for path in first:
                p0 = traffic.leaf(session.seed, order[path], specs[path], dev)
                change[path] = C.norm(leaves[path] - p0)
        return {"losses": losses, "first_grad": first, "change": change,
                "batch_max_abs": gap, "field_record": rec}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def setup(cell: Dict, config: Dict, seed: int) -> Session:
    return Session(cell, config, seed)


def window(session: Session, seconds: float):
    return session.window(seconds)


def trace(session: Session):
    return session.trace()
