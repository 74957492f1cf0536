"""Driver of descriptor training: the program's ``train/pose_trainer.py``
``pose_train_step`` on one half's views, one step a unit of work.

Set-up makes the half's views of the analytic object at ``image_size``
with their masks, the ray bank (each view's front hits: NDC xys, surface
point, valid), the negative keys (surface points) and the weights of the
field and the ResNet-UNet, all from the seed on the card; it builds the
program's state from them (``init_pose_state``) and drives it through the
checked steps, then a few warm-up steps.  The window calls
``pose_train_step`` with a batch of views (a fresh permutation a step, the
trainer's ``view_schedule`` rule), the augmentation that ``train_pose``
applies by default, and the step's draws, made by the benchmark; the
sampled rays are drawn inside the step from the benchmark's generator.

The check replays the checked steps through the plain reference
(``portbench/reference/pose.py``): the same weights, views, ray bank,
negatives and draws, the sampled rays from the generator in the state the
step found it, and compares each step's loss, the first gradient (from
the program's Adam moments) and the parameters' change.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import clock, compare, faults, scene, weights
from portbench.harness.trace import span
from portbench.reference import pose as ref_pose
from portbench.reference.field import is_head
from portbench.reference.precision import Precision, no_tf32

SPANS = ("pose.",)


def aug_draws(g: torch.Generator, B: int, S: int, ac: dict) -> dict:
    """One batch's augmentation draws (the distributions of the trainer's
    augmentation, ``train/augment.py``)."""
    dev = g.device

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand((B,) + shape, generator=g, device=dev) * (hi - lo) + lo

    j, tf = ac["scale_jitter"], ac["trans_frac"]
    return dict(
        rot=u(), scale=u(lo=1.0 - j, hi=1.0 + j), trans=u(2, lo=-tf, hi=tf), occlude=u(4), occlude_on=u(),
        line=u(3), line_on=u(), background=u(8, 8, 3), background_on=u(), gain=u(3, lo=0.8, hi=1.2),
        bias=u(3, lo=-0.08, hi=0.08), gamma=u(lo=0.8, hi=1.25), jitter_on=u(), border_on=u(),
        shift=torch.randint(-S // 2, S // 2, (B, 2), generator=g, device=dev), distractor_on=u(),
        sigma=u(lo=0.3, hi=1.0), blur_on=u(), iso_intensity=u(lo=0.1, hi=0.5), iso_shift=u(lo=0.01, hi=0.05),
        iso_luma=torch.randn((B, S, S, 1), generator=g, device=dev),
        iso_chroma=torch.randn((B, S, S, 3), generator=g, device=dev), iso_on=u())


class Driver:
    def __init__(self, cfg: dict, tr: dict, seed: int, device, trace: bool = False):
        self.cfg, self.tr, self.seed, self.dev, self.trace = cfg, tr, seed, torch.device(device), trace
        self.losses = []

    # ------------------------------------------------------------ set-up
    def setup(self):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig, PoseTrainConfig
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment, pose_trainer

        self.pt, self.aug = pose_trainer, augment
        tr, fc, uc, dev = self.tr, self.cfg["field"], self.cfg["unet"], self.dev
        V, S, B = tr["views"], tr["image_size"], tr["batch_size"]
        self.gen = torch.Generator(device=dev).manual_seed(self.seed)
        v = scene.views(self.gen, V, S, hits=True)
        self.bank = scene.ray_bank(v)
        self.images, self.sils = v["images"], v["sils"]
        del v
        self.neg = scene.surface_points(self.gen, tr["n_neg"])
        clock.mark("inputs")
        self.field_p = weights.field_params(self.gen, fc)
        self.cnn_p = weights.unet_params(self.gen, uc)
        with torch.device(dev):
            field = fields.NerfField(FieldConfig(**{k: x for k, x in fc.items() if k in FieldConfig.__dataclass_fields__}))
            cnn = ResNetUNet(uc["n_class"], uc["stage_sizes"], uc["widths"], uc["decoder_width"],
                             getattr(torch, uc["dtype"]))
        field.load_state_dict(self.field_p)
        cnn.load_state_dict(self.cnn_p)
        keys = PoseTrainConfig.__dataclass_fields__
        self.cfg_pt = PoseTrainConfig(**{k: x for k, x in tr.items() if k in keys})
        self.aug_cfg = augment.AugmentConfig(**tr["aug"])
        self.state = pose_trainer.init_pose_state(field, self.cfg_pt, cnn, device=dev)
        del field, cnn
        self.opt = pose_trainer.make_pose_optimizer(self.cfg_pt)
        rng = np.random.default_rng(self.seed)
        self.sched = torch.as_tensor(np.stack([rng.permutation(V)[:B] for _ in range(tr["max_steps"])]), device=dev)
        clock.mark("program state")
        self.i = 0
        self.checked = {"idx": [], "draws": [], "gen": [], "losses": []}
        for k in range(tr["checked_steps"]):
            idx, d, gs, loss = self._step(keep=True)
            for key, x in zip(("idx", "draws", "gen", "losses"), (idx, d, gs, loss)):
                self.checked[key].append(x)
            if k == 0:
                b1 = 0.9
                o = self.state.opt
                self.first_grads = dict(zip(self._keys(), [m.clone() / (1 - b1) for m in o.head_mu + o.cnn_mu]))
        clock.mark("checked steps")
        self.after = dict(zip(self._keys(), [p.detach().clone() for p in self._params()]))
        for _ in range(tr["warmup_extra"]):
            self.step()
        self.losses = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _keys(self) -> list:
        head = [("head", n) for n, _ in self.state.field.named_parameters() if is_head(n)]
        return head + [("cnn", n) for n, _ in self.state.cnn.named_parameters()]

    def _params(self) -> list:
        return self.pt.head_params(self.state.field) + list(self.state.cnn.parameters())

    def _draws(self):
        tr, B, g = self.tr, self.tr["batch_size"], self.gen
        a = aug_draws(g, B, tr["image_size"], tr["aug"])
        neg_idx = torch.randint(0, self.neg.shape[0], (B, tr["sample_size"]), generator=g, device=self.dev)
        jitter = torch.randn((B, tr["sample_size"], 3), generator=g, device=self.dev)
        return a, neg_idx, jitter

    def _step(self, keep: bool = False):
        with span(self.trace, "pose.feed"):
            idx = self.sched[self.i % self.sched.shape[0]]
            a, neg_idx, jitter = self._draws()
            draws = self.pt.PoseDraws(self.aug.AugmentDraws(**a), None, None, None, neg_idx, jitter)
            b = self.bank
            gs = self.gen.get_state() if keep else None
        with span(self.trace, "pose.train_step"):
            self.state, loss, _ = self.pt.pose_train_step(
                self.state, self.opt, self.images[idx], self.sils[idx], b["pos_vec"][idx], b["xys"][idx],
                b["valid"][idx], self.neg, self.cfg_pt, self.aug_cfg, draws, self.gen, mesh=None)
        self.i += 1
        return idx, ({"aug": a, "neg_idx": neg_idx, "neg_jitter": jitter} if keep else None), gs, loss

    # ------------------------------------------------------------ window
    def step(self) -> int:
        *_, loss = self._step()
        self.losses.append(loss)
        return self.tr["batch_size"] * self.tr["sample_size"]

    def failed(self) -> int:
        return int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0

    def end_to_end(self, window_s: float, work: int) -> dict:
        return {"pose_samples_per_s": work / window_s}

    def release(self):
        self.state = self.opt = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def readings(self) -> dict:
        return {"losses": torch.stack(self.checked["losses"]), "grads": self.first_grads, "params": self.after}

    def reference(self, precision: str, follow: dict | None = None) -> dict:
        """The reference's checked steps computed in ``precision`` (``follow``
        is not needed: the reference recomputes every stage itself)."""
        no_tf32()
        fc, b = self.cfg["field"], self.bank
        compute = Precision(precision if fc["compute_dtype"] != "float32" else "float32")
        store = Precision(precision if fc["act_dtype"] != "float32" else "float32")
        batches = [{"images": self.images[i], "sils": self.sils[i], "pos_vec": b["pos_vec"][i], "xys": b["xys"][i],
                    "valid": b["valid"][i], "neg_pts": self.neg} for i in self.checked["idx"]]
        tr = {**self.tr, **{k: getattr(self.cfg_pt, k) for k in self.cfg_pt.__dataclass_fields__}}
        out = ref_pose.train(self.cfg, tr, self.tr["aug"], self.field_p, self.cnn_p, batches, self.checked["draws"],
                             self.checked["gen"], (compute, store))
        out["init"] = {**{("head", k): v for k, v in self.field_p.items() if is_head(k)},
                       **{("cnn", k): v for k, v in self.cnn_p.items()}}
        return out

    def check(self, limits: dict) -> list:
        prog = self.readings()
        self.release()
        return compare_to(prog, self.reference("bfloat16"), limits)


def compare_to(got: dict, ref: dict, limits: dict) -> list:
    return compare.training_checks(got, ref, limits)


def calibration(drv, mode: str, limits: dict, detail: bool = False) -> dict:
    return compare.training_calibration(compare_to, drv, mode, limits, detail)


def _patch(name: str, make):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer

    return faults.patch(pose_trainer, name, make)


def _unchanged():
    """A step that leaves the state as it was: Adam never applied."""
    return _patch("adam_update_", lambda orig: lambda params, grads, mu, nu, count, lr, wd=0.0: count + 1)


def _half_batch():
    """Half of each step's views left out, the mean taken over the rest."""
    def make(orig):
        def losses(field, cnn, aug, new_xys, sel, pos_vec, pos_noise, neg_pts, neg_idx, neg_jitter, cfg):
            k = new_xys.shape[0] // 2
            part = aug._replace(**{f: getattr(aug, f)[:k] for f in aug._fields})
            pn = None if pos_noise is None else pos_noise[:k]
            return orig(field, cnn, part, new_xys[:k], sel[:k], pos_vec[:k], pn, neg_pts, neg_idx[:k],
                        neg_jitter[:k], cfg)
        return losses
    return _patch("_view_losses", make)


FAULTS = {"fault_unchanged": _unchanged, "fault_half_batch": _half_batch}
