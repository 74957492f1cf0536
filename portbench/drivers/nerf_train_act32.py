"""Driver of NeRF training on a field that stores its activations in
float32: ``nerf_train``'s window, check and faults, and one number more,
``act``, which tells the stated activation storage from bf16's.

Why a number more: the rounding of stored activations to bf16 moves each
point's sigmoid' and the density head's weight grad by up to 2^-9 of the
value, a different amount at each point, so over a step's ~770,000 points
it averages out of every summed gradient, below the gap between the plain
reference (flax's rounding points: each product's result rounded to bf16)
and a sound program (the field kernels: f32 sums).  No number of
``nerf_train``'s check tells the two storages apart.

The probe: after the checked steps the program takes one step more, from
fresh states, on the first checked step's views and draws, with a field
whose every point holds the same activations: the first layer's kernel
nought and its bias on bf16's grid, the second layer and the colour
layer's view-independent part the identity, its view part nought, and the
colour head reading one unit a channel.  Every product's result is then on
bf16's grid, so the reference and the program compute the same forward to
f32 sums, and the density head's weight grad is h2 times the sum of the
points' du, its bias grad that sum: their ratio, unit by unit, is the h2
the backward read.  ``act`` is the widest relative gap, over halves and
passes, between the program's ratio and the reference's (the reference at
the configuration's precision, on the program's fine depths).  With h2
kept in float32 the two agree to f32 sums; with h2 read in bf16 they part
by bf16's rounding of h2, ~1e-3.
"""

from __future__ import annotations

import math

import torch

from portbench.drivers import nerf_train
from portbench.harness import compare, faults
from portbench.reference import nerf as ref_nerf
from portbench.reference.precision import Precision, no_tf32

SPANS = nerf_train.SPANS
# the probe field's density, a point's alpha: a ray's opacity ~0.96 in the
# coarse pass (64 points).  At a thin field (alpha 0.005) the points' du
# cancel in their sum, the bias grad, to ~1/200 of their absolute sum, and
# the ratio's f32 sums read up to 1.6e-4 (CPU, 48 hidden); at 0.05 ~2e-6
PROBE_ALPHA = 0.05
# the density head's two leaves whose ratio the probe reads
WD, BD = "density_layer.weight", "density_layer.bias"


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _softplus(x: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.nn.functional.softplus(x, beta=beta)


def probe_params(p: dict, beta: float) -> dict:
    """The probe field of one pass from that pass's weights ``p`` (a state
    dict; the key head kept): every point holds h1 = softplus(b1), h2 =
    softplus(bf16(h1)), c1 = softplus(bf16(h2)), the units' b1 (on bf16's
    grid, ~N(0, 0.2^2), where softplus_10 bends, so that h2 lies off the
    grid) drawn from the first layer's first column; the density bias sets
    each point's alpha to ``PROBE_ALPHA``."""
    q = dict(p)
    nh = p["trunk2.weight"].shape[0]
    eye = torch.eye(nh, device=p["trunk2.weight"].device)
    q["trunk1.weight"] = torch.zeros_like(p["trunk1.weight"])
    w = p["trunk1.weight"][:, 0]
    q["trunk1.bias"] = _bf16(0.2 * w / w.std())
    q["trunk2.weight"], q["trunk2.bias"] = eye, torch.zeros(nh, device=eye.device)
    q["color1.weight"] = torch.cat([eye, torch.zeros_like(p["color1.weight"][:, nh:])], 1)
    q["color1.bias"] = torch.zeros(nh, device=eye.device)
    q["color2.weight"] = torch.zeros_like(p["color2.weight"])
    q["color2.weight"][torch.arange(3), torch.arange(3)] = 1.0
    q["color2.bias"] = torch.zeros(3, device=eye.device)
    h2 = _softplus(_bf16(_softplus(q["trunk1.bias"], beta)), beta)
    raw = -math.log1p(-PROBE_ALPHA)
    pre = math.log(math.expm1(beta * raw)) / beta                         # softplus_beta(pre) = raw
    q[BD] = (pre - (h2 * q[WD][0]).sum()).reshape(1)
    return q


def act_gap(got: dict, want: dict) -> float:
    """The widest relative gap, over (half, pass), between two sides'
    density-head weight grad over its bias grad (the h2 each backward
    read); inf where a side's bias grad is nought or not finite."""
    worst = 0.0
    for h, p, name in want:
        if name != BD:
            continue
        g, w = (d[(h, p, WD)][0].double() / d[(h, p, BD)][0].double() for d in (got, want))
        gap = float((g - w).norm() / w.norm())
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


class Driver(nerf_train.Driver):
    def setup(self):
        super().setup()
        beta = float(self.cfg["field"]["softplus_beta"])
        self.probe_init = [{p: probe_params(half[p], beta) for p in half} for half in self.init]

    def probe(self) -> dict:
        """The program's probe step: fresh states of the probe fields, one
        ``train_step`` on the first checked step's views and draws; its
        grads (from Adam's first moments, as the checked steps') and the
        fine depths it resampled."""
        nt, tr, H = self.nt, self.tr, self.tr["halves"]
        states = [nt.init_state(self.field_cfg, self.train_cfg, init_params=(h["coarse"], h["fine"]), device=self.dev)
                  for h in self.probe_init]
        idx, draws = self.checked["batches"][0], self.checked["draws"][0]
        c = self.cams
        cam = self.Camera(c.R[self.hh, idx], c.T[self.hh, idx], c.focal[self.hh, idx], c.principal[self.hh, idx],
                          c.image_size)
        images, sils = self.data["images"][self.hh, idx], self.data["sils"][self.hh, idx]
        with nerf_train._recording_depths() as z:
            states, _, _ = nt.train_step(states, cam, images, sils, self.opt, self.render_cfg, self.train_cfg,
                                         self.min_d, self.max_d, draws=draws, **self.chunk)
        grads = {}
        for h, st in enumerate(states):
            keys = [(h, p, n) for p, f in (("coarse", st.coarse), ("fine", st.fine)) for n, _ in nt.trainable(f)]
            grads.update(zip(keys, (m.clone() / (1 - nt.Adam.b1) for m in st.opt.mu)))
        return {"grads": grads, "depths": [nerf_train.joined_depths(z, H, tr["cams_per_step"] * tr["rays_per_image"])]}

    def probe_reference(self, store: str, fine_depths=None) -> dict:
        """The reference's probe step: products at the configuration's
        precision, activations stored in ``store``; its fine pass on
        ``fine_depths`` where given."""
        no_tf32()
        fc, d, tr = self.cfg["field"], self.data, self.tr
        idx = self.checked["batches"][0]
        prec = (Precision("float32" if fc["compute_dtype"] == "float32" else "bfloat16"), Precision(store))
        views = [{"images": d["images"][h, idx[h]], "sils": d["sils"][h, idx[h]], "R": d["R"][h, idx[h]],
                  "t": d["t"][h, idx[h]], "K": d["K"][h, idx[h]], "min_depth": self.min_d, "max_depth": self.max_d}
                 for h in range(tr["halves"])]
        usable = fine_depths is not None and all(z is not None for zs in fine_depths for z in zs)
        return ref_nerf.train(fc, tr, self.probe_init, [views], [self.checked["draws"][0]], prec,
                              fine_depths if usable else None)

    def check(self, limits: dict) -> list:
        prog, probe = self.readings(), self.probe()
        self.release()
        ref = self.probe_reference(self.cfg["field"]["act_dtype"], probe["depths"])
        return (nerf_train.compare_to(prog, self.reference("bfloat16", prog), limits)
                + [("act", act_gap(probe["grads"], ref["grads"]), limits["act"])])


def calibration(drv, mode: str, limits: dict, detail: bool = False) -> dict:
    """``nerf_train``'s readings and ``act``.  For "control", ``act`` puts
    in the program's place the reference with its activations stored in
    bf16, the precision below the configuration's float32 (the other
    numbers' control lowers the products to fp8)."""
    got = None if mode == "control" else drv.probe()
    out = compare.training_calibration(nerf_train.compare_to, drv, mode, limits, detail)
    if got is None:
        got = drv.probe_reference("bfloat16")
    ref = drv.probe_reference(drv.cfg["field"]["act_dtype"], got["depths"])
    out["act"] = act_gap(got["grads"], ref["grads"])
    return out


def _bf16_acts():
    """K4's bf16-activation variant on this field: the backward reads the
    activations rounded to bf16, the precision below the stated one."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel

    return faults.patch(field_kernel, "bundle_loss_op", lambda orig: lambda *a: orig(*a[:-1], "bfloat16"))


# faults planted in the timed path, for the check's own tests and readings
FAULTS = {**nerf_train.FAULTS, "fault_bf16_acts": _bf16_acts}
