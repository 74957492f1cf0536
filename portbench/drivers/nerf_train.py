"""Driver of NeRF training: the program's ``train/nerf_trainer.py``
``train_step`` on both halves, one step a unit of work.

Set-up makes each half's views of the analytic object and both fields'
weights from the seed on the card (the density head's drawn
``density_gain`` times the init's spread: at the init's own spread the
random field is empty, mean density 4e-7, and the composite, the
resampling and the loss would see nothing), builds the program's train states from
them and drives them through the checked steps (the window's own call and
feed, on batches that all differ), then a few more warm-up steps.  The
window then calls ``train_step`` on the same states: a batch of
``cams_per_step`` views a half from shuffled epochs (the trainer's
``half_schedule`` rule), and the step's draws (ray xys, depth jitter,
resampling uniforms), made by the benchmark and handed to the step, with
the traffic's ``ray_chunk`` where it names one (else the step keeps its
own).  A step of at most a chunk of rays a half, on a field the fused
kernel takes, runs K4; any other runs the chunked step, through K5 / K6 or
the field's own colour path.

The check replays the checked steps through the plain reference
(``portbench/reference/nerf.py``) from the same weights, views and draws,
its fine passes on the program's fine depths (every resampling of a step,
one a chunk on the chunked path, joined along the rays), and compares each
step's loss, the first gradient (from the program's Adam moments after one
step), the parameters' change over the checked steps and the resampled
depths; and it runs the steps a second time through the reference alone,
which resamples its own fine depths, and compares each step's loss with
that run's (``loss_own``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import clock, compare, faults, scene, weights
from portbench.harness.trace import span
from portbench.reference import nerf as ref_nerf
from portbench.reference.precision import Precision, no_tf32

SPANS = ("nerf.",)


def schedule(n_views: int, batch: int, steps: int, seed: int) -> np.ndarray:
    """(steps, batch) view indices: shuffled epochs, the last short batch
    filled from the epoch's start."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < steps:
        perm = rng.permutation(n_views)
        for i in range(max(n_views // batch, 1)):
            idx = perm[i * batch: i * batch + batch]
            if len(idx) < batch:
                idx = np.concatenate([idx, perm[: batch - len(idx)]])
            out.append(idx)
    return np.stack(out[:steps])


class Driver:
    def __init__(self, cfg: dict, tr: dict, seed: int, device, trace: bool = False):
        self.cfg, self.tr, self.seed, self.dev, self.trace = cfg, tr, seed, torch.device(device), trace
        self.losses = []

    # ------------------------------------------------------------ set-up
    def setup(self):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
            FieldConfig,
            NerfTrainConfig,
            RenderConfig,
        )
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

        self.nt = nerf_trainer
        tr, fc, dev = self.tr, self.cfg["field"], self.dev
        self.chunk = {"ray_chunk": tr["ray_chunk"]} if "ray_chunk" in tr else {}
        H, V, S, B = tr["halves"], tr["views_per_half"], tr["image_size"], tr["cams_per_step"]
        self.gen = torch.Generator(device=dev).manual_seed(self.seed)
        halves = [scene.views(self.gen, V, S) for _ in range(H)]
        self.data = {k: torch.stack([h[k] for h in halves]) for k in halves[0]}
        tz = self.data["t"][..., 2].abs()
        self.min_d, self.max_d = float(tz.min()) - tr["depth_margin"], float(tz.max()) + tr["depth_margin"]
        clock.mark("inputs")
        self.init = [{p: weights.field_params(self.gen, fc, tr["density_gain"]) for p in ("coarse", "fine")}
                     for _ in range(H)]
        self.field_cfg = FieldConfig(**{k: v for k, v in fc.items() if k in FieldConfig.__dataclass_fields__})
        self.render_cfg = RenderConfig(n_rays_per_image=tr["rays_per_image"], n_pts_coarse=tr["n_pts_coarse"],
                                       n_pts_fine=tr["n_pts_fine"], add_input_samples=tr["add_input_samples"])
        self.train_cfg = NerfTrainConfig(lr=tr["lr"], warmup_steps=tr["warmup_steps"], batch_size=B,
                                         loss_scale=tr["loss_scale"], huber_scaling=tr["huber_scaling"])
        self.states = [nerf_trainer.init_state(self.field_cfg, self.train_cfg, init_params=(h["coarse"], h["fine"]),
                                               device=dev) for h in self.init]
        self.opt = nerf_trainer.make_optimizer(self.train_cfg)
        self.cams = cameras.camera_from_bop(self.data["R"], self.data["t"], self.data["K"], S)
        self.Camera = cameras.Camera
        sched = np.stack([schedule(V, B, tr["max_steps"], self.seed + 7919 * (h + 1)) for h in range(H)], 1)
        self.sched = torch.as_tensor(sched, device=dev)                        # (steps, H, B)
        self.hh = torch.arange(H, device=dev)[:, None]
        clock.mark("program state")
        self.i = 0
        # the checked steps, then warm-up steps, through the window's call
        self.checked = {"batches": [], "draws": [], "losses": [], "depths": []}
        for k in range(tr["checked_steps"]):
            with _recording_depths() as z:
                idx, draws, loss = self._step(keep=True)
            self.checked["depths"].append(joined_depths(z, H, B * tr["rays_per_image"]))
            self.checked["batches"].append(idx)
            self.checked["draws"].append(draws)
            self.checked["losses"].append(loss)
            if k == 0:
                b1 = nerf_trainer.Adam.b1
                self.first_grads = self._by_key([[m.clone() / (1 - b1) for m in st.opt.mu] for st in self.states])
        clock.mark("checked steps")
        self.after = self._by_key([[p.detach().clone() for p in nerf_trainer.train_params(st)] for st in self.states])
        for _ in range(tr["warmup_extra"]):
            self.step()
        self.losses = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _by_key(self, per_half: list) -> dict:
        """{(half, pass, name): tensor} from each half's list in the
        program's ``train_params`` order (coarse, then fine)."""
        out = {}
        for h, (st, vals) in enumerate(zip(self.states, per_half)):
            keys = [(h, p, n) for p, f in (("coarse", st.coarse), ("fine", st.fine)) for n, _ in self.nt.trainable(f)]
            out.update(zip(keys, vals))
        return out

    def _draws(self):
        tr, H, B = self.tr, self.tr["halves"], self.tr["cams_per_step"]
        n, g, dev = tr["rays_per_image"], self.gen, self.dev
        xys = torch.rand((H, B, n, 2), generator=g, device=dev) * 2.0 - 1.0
        u = torch.rand((H, B, n, tr["n_pts_coarse"]), generator=g, device=dev)
        u_pdf = torch.rand((H, B * n, tr["n_pts_fine"]), generator=g, device=dev) * (1.0 - 1e-6)
        return xys, u, u_pdf

    def _step(self, keep: bool = False):
        with span(self.trace, "nerf.feed"):
            idx = self.sched[self.i % self.sched.shape[0]]                     # (H, B)
            c = self.cams
            cam = self.Camera(c.R[self.hh, idx], c.T[self.hh, idx], c.focal[self.hh, idx],
                              c.principal[self.hh, idx], c.image_size)
            images, sils = self.data["images"][self.hh, idx], self.data["sils"][self.hh, idx]
            draws = self._draws()
        with span(self.trace, "nerf.train_step"):
            self.states, loss, _ = self.nt.train_step(self.states, cam, images, sils, self.opt, self.render_cfg,
                                                      self.train_cfg, self.min_d, self.max_d, draws=draws,
                                                      **self.chunk)
        self.i += 1
        return (idx, draws if keep else None, loss)

    # ------------------------------------------------------------ window
    def step(self) -> int:
        _, _, loss = self._step()
        self.losses.append(loss)
        return self.tr["halves"] * self.tr["cams_per_step"] * self.tr["rays_per_image"]

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses)).all(-1)).sum())

    def end_to_end(self, window_s: float, work: int) -> dict:
        return {"nerf_rays_per_s": work / window_s}

    def release(self):
        """Free the program's state before the reference runs."""
        self.states = self.opt = self.cams = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def readings(self) -> dict:
        return {"losses": torch.stack(self.checked["losses"]), "grads": self.first_grads, "params": self.after,
                "depths": self.checked["depths"]}

    def reference(self, precision: str, follow: dict | None = None) -> dict:
        """The reference's checked steps computed in ``precision``.  Where
        ``follow`` (the readings of the side under test) is given, its fine
        passes run on ``follow``'s depths, and ``own_losses`` are the losses
        of a second run, which resamples its fine depths from its own coarse
        weights throughout."""
        out = self._reference(precision, None if follow is None else follow["depths"])
        if follow is not None:
            out["own_losses"] = self._reference(precision, None)["losses"]
        return out

    def _reference(self, precision: str, fine_depths) -> dict:
        no_tf32()
        fc, tr, d = self.cfg["field"], self.tr, self.data
        prec = (Precision(precision if fc["compute_dtype"] != "float32" else "float32"),
                Precision(precision if fc["act_dtype"] != "float32" else "float32"))
        batches = []
        for idx in self.checked["batches"]:
            batches.append([{"images": d["images"][h, idx[h]], "sils": d["sils"][h, idx[h]], "R": d["R"][h, idx[h]],
                             "t": d["t"][h, idx[h]], "K": d["K"][h, idx[h]], "min_depth": self.min_d,
                             "max_depth": self.max_d} for h in range(tr["halves"])])
        usable = fine_depths is not None and all(z is not None for zs in fine_depths for z in zs)
        out = ref_nerf.train(fc, tr, self.init, batches, self.checked["draws"], prec,
                             fine_depths if usable else None)
        out["init"] = {(h, p, k): v for h, half in enumerate(self.init) for p in half for k, v in half[p].items()}
        return out

    def check(self, limits: dict) -> list:
        prog = self.readings()
        self.release()
        return compare_to(prog, self.reference("bfloat16", prog), limits)


def compare_to(got: dict, ref: dict, limits: dict) -> list:
    """The check's numbers of readings ``got`` (as ``Driver.readings``
    gives them) against the reference's, run on ``got``'s fine depths:
    the training numbers, and the fine depths ``got`` resampled against
    those the reference resampled from its own coarse weights; and
    ``loss_own``, each step's loss against the reference's run on its own
    depths from the start, which follows nothing of ``got``."""
    return compare.training_checks(got, ref, limits) + [
        ("depth", compare.depth_gap(got["depths"], ref["depths"]), limits["depth"]),
        ("loss_own", compare.rel_gap(got["losses"], ref["own_losses"]), limits["loss_own"])]


def joined_depths(calls: list, H: int, R: int) -> list:
    """A step's fine depths per half, (R, P) each: the outputs of its
    ``importance_resample`` calls, (H, rays, P) each (one call on the K4
    path, one a chunk on the chunked path, in ray order), joined along the
    rays; None for each half where they do not make R rays."""
    z = torch.cat(calls, 1) if calls else None
    return [z[h] if z is not None and z.shape[:2] == (H, R) else None for h in range(H)]


class _recording_depths:
    """Records the fine depths the program's step resamples (each output of
    its ``raymarch.importance_resample``), for the reference to run its
    fine pass on the same points."""

    def __enter__(self):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch

        self.mod, self.orig, self.out = raymarch, raymarch.importance_resample, []

        def spy(*a, **k):
            z = self.orig(*a, **k)
            self.out.append(z.detach().clone())
            return z

        raymarch.importance_resample = spy
        return self.out

    def __exit__(self, *exc):
        self.mod.importance_resample = self.orig


def calibration(drv, mode: str, limits: dict, detail: bool = False) -> dict:
    return compare.training_calibration(compare_to, drv, mode, limits, detail)


def _patch(name: str, make):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    return faults.patch(nerf_trainer, name, make)


def _unchanged():
    """A step that leaves the state as it was: Adam never applied."""
    return _patch("adam_update_", lambda orig: lambda params, grads, mu, nu, count, lr, wd=0.0: count + 1)


def _half_batch():
    """Half of each step's rays left out, the mean taken over the rest: in
    whichever of the K4 step (``_fused_sums``) and the chunked step
    (``_chunked_losses``) the step takes."""
    def make(orig):
        def half(states, o, d, lengths, col, sil, u_pdf, render_cfg, train_cfg, *rest):
            k = o.shape[1] // 2
            return orig(states, o[:, :k], d[:, :k], lengths[:, :k], col[:, :k], sil[:, :k], u_pdf[:, :k], render_cfg,
                        train_cfg, *rest[:-1], k)
        return half
    undo = [_patch(name, make) for name in ("_fused_sums", "_chunked_losses")]

    def restore():
        for u in undo:
            u()
    return restore


# faults planted in the timed path, for the check's own tests and readings
FAULTS = {"fault_unchanged": _unchanged, "fault_half_batch": _half_batch}
