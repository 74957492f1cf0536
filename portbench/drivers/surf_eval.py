"""Driver of SurfEmb's pose estimator: the program's
``pipeline/inference.py`` ``estimate_pose_surfemb`` with refinement, one
crop a unit of work, one caller that waits for each answer, as
``inference --use-surf-eval`` and ``poses-est`` call it for every image of
the other half-sequence.

Set-up makes a sequence of ``views`` crops of the analytic object
(ImageNet-normalized, with their crop cameras) and as many views more,
the ResNet-UNet's weights, and ``n_keys`` baked keys with their surface
points, all from the seed on the card, as ``serve.py`` ``Driver.baked_keys``
bakes them (the reference ResNet-UNet's queries at the object pixels on the
stride's grid), and each point's normal: the normal of the sphere of the
object it lies on.  The output layer is set as a trained one behaves: its
query rows scaled by ``QUERY_GAIN`` (a random layer's distribution is flat
over the 80,000 keys) and its mask row fitted to the views' silhouettes
(``fit_mask``; a random one's mask is noise, and its draws fall off the
object).  It warms the path with a few requests.  The window sends the
crops in turn, each with its ``SurfEmbDraws`` from the benchmark's
generator (``inference._draw_surfemb``'s order), and times each from the
call to its pose on the host.

The check takes the first request and two more drawn from the seed among
the first ``check_span``.  For each it holds the program's stages to the
plain reference (``reference/surfemb.py``) on the program's own state: the
query and mask maps against the reference ResNet-UNet's (``query``), the
drawn (pixel, key) indices against the exact cdf on the program's maps:
the largest probability mass by which a request's uniform lies outside
the exact bin of the index drawn for it (``draw``); the hypotheses of the
program's drawn indices and root picks against the reference's float64
P3P, root pick and pruning: of the drawn 4-tuples that either keeps, the
share whose keep differs, or whose kept pose lies more than ``HYP_TOL``
apart (``hyp``);
the evaluated hypotheses against the first ``max_pose_evaluations`` that
the program's own pruning kept, in order, bit for bit (``order``: the
share of slots that differ) and the refinement's start against the best
of their scores, bit for bit (``start``: 0 or 1); the scores of the
program's evaluated hypotheses (``score``); and the refinement against
the objective set up at the program's start: the share of the gain from
the start that the reference's BFGS, continued from the program's refined
pose, still finds (``refine``, the median over the sampled requests:
``combine`` says why), and the objective the program reports at its
answer (``objective``).

Three numbers are left out of the check.  The share of draws
whose index differs from the exact cdf's (``moved``, which the
calibration prints) spreads with the weights (1-9 % of 40,000 on sound
seeds, 21-39 % under the float32 cdf): a draw within the float32 entries'
rounding of a bin's edge moves to the neighbouring bin, which ``draw``
sees as next to nothing.  The reference's own
refinement from the program's start does not make a limit: two float32
BFGS paths from one start part where a line-search trial passes in one
and fails in the other, and on these maps the two ends differ by up to 7
% in the objective, more than a 0.05 rad turn of the answer moves it.  Nor
does the gap to the reference's own answer from the crop alone
(``numbers(pose=True)``, which the calibration prints): on maps of random
weights the best hypothesis is one of many near ties and the refinement
drifts from it, so the two answers lie 0.03-0.7 apart (angle plus
relative translation), and every planted fault falls inside that range.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from portbench.drivers import serve
from portbench.harness import clock, faults, scene, weights
from portbench.harness.trace import span
from portbench.reference import surfemb as ref
from portbench.reference import unet as ref_unet
from portbench.reference.precision import Precision, no_tf32

SPANS = ("surf_eval.",)
# what the program's entry point fixes and the configuration states
ENTRY_DEFAULTS = {"max_pool": True, "n_denom": 10960}
# the output layer as a trained one behaves: the query rows scaled by
# QUERY_GAIN, the mask row fitted to +-MASK_LOGIT on and off the object.
# Gain 30 is the least of a sweep (3, 10, 30, 100) at which every one of the
# 1,000 evaluated slots holds a hypothesis that survived the pruning (3:
# 340-461, 10: 510-841); at 100 the best scores fall to -4 to -8 (-1.5 to
# -2.8 at 30): the distribution is sharper than the points that win their
# pixels
QUERY_GAIN = 30.0
MASK_LOGIT = 6.0
# a hypothesis whose pose the program's float32 P3P and the reference's
# float64 P3P give farther apart than this (rotation angle plus translation
# gap relative to |t|) counts as differing in ``hyp``.  On the card the
# poses both keep lie 0.0025-0.009 apart at the median and 0.1-0.3 at the
# 90th percentile (ill-posed triples, whose float32 roots move far); another
# root of the same triple lies 1.4-1.5 apart at the median
HYP_TOL = 0.1


def sphere_normals(points: torch.Tensor) -> torch.Tensor:
    """The outward normal of the sphere of the analytic object that each
    point (N, 3) lies on."""
    c = torch.tensor(scene.CENTERS, device=points.device)
    r = torch.tensor(scene.RADII, device=points.device)
    d = points[:, None] - c
    which = torch.argmin((torch.linalg.vector_norm(d, dim=-1) - r).abs(), 1)
    n = d[torch.arange(points.shape[0], device=points.device), which]
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def object_diameter() -> float:
    """The analytic object's diameter: the widest pair of its spheres'
    points."""
    c, r = torch.tensor(scene.CENTERS, dtype=torch.float64), torch.tensor(scene.RADII, dtype=torch.float64)
    return float((torch.cdist(c, c) + r[:, None] + r[None]).max())


class _Recorder:
    """Records, for one request that the check samples, what the program
    hands between its stages: the CNN's maps, the drawn indices, the scored
    hypotheses and the refinement's start.  Installed around that request
    alone; it keeps references to the program's tensors, which nothing
    writes afterwards, and copies nothing."""

    def __init__(self, cnn):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf, pose_refine

        self.cnn, self.pes, self.pr, self.rec = cnn, pose_est_surf, pose_refine, {}

    def __enter__(self):
        rec, pes, pr = {}, self.pes, self.pr
        self.rec, self.orig = rec, (pes.inverse_cdf, pes._solve_and_prune, pes.estimate_pose, pr.refine_pose)
        inverse, solve, estimate, refine = self.orig

        def inverse_cdf(cdf, u):
            rec["idx"] = inverse(cdf, u)
            return rec["idx"]

        def solve_and_prune(*a, **k):
            out = solve(*a, **k)
            rec.update(R_all=out[0], t_all=out[1], keep_all=out[2])
            return out

        def estimate_pose(*a, **k):
            res = estimate(*a, **k)
            rec.update(R_e=res.R, t_e=res.t, score=res.pose_scores, valid=res.valid)
            return res

        def refine_pose(R0, t0, *a, **k):
            rec.update(R0=R0, t0=t0)
            out = refine(R0, t0, *a, **k)
            rec.update(f=out[2])
            return out

        self.hook = self.cnn.register_forward_hook(lambda m, i, out: rec.update(maps=out[0]))
        pes.inverse_cdf, pes._solve_and_prune, pes.estimate_pose, pr.refine_pose = (inverse_cdf, solve_and_prune,
                                                                                    estimate_pose, refine_pose)
        return rec

    def __exit__(self, *exc):
        self.hook.remove()
        self.pes.inverse_cdf, self.pes._solve_and_prune, self.pes.estimate_pose, self.pr.refine_pose = self.orig


class Driver:
    def __init__(self, cfg: dict, tr: dict, seed: int, device, trace: bool = False):
        self.cfg, self.tr, self.seed, self.dev, self.trace = cfg, tr, seed, torch.device(device), trace
        self.s = cfg["surfemb"]
        self.latencies, self.answers, self.sampled = [], [], []

    def setup(self):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference

        s, tr, uc, dev = self.s, self.tr, self.cfg["unet"], self.dev
        for k, v in ENTRY_DEFAULTS.items():
            if s[k] != v:
                raise ValueError(f"estimate_pose_surfemb runs {k}={v!r}, not {s[k]!r}")
        self.inf = inference
        self.icfg = InferenceConfig(down_sample=s["down_sample"], max_poses=s["max_poses"],
                                    max_pose_evaluations=s["max_pose_evaluations"], alpha=s["alpha"],
                                    dist_2d_min=s["dist_2d_min"])
        self.gen = torch.Generator(device=dev).manual_seed(self.seed)
        V = tr["views"]
        v = scene.views(self.gen, 2 * V, tr["image_size"], hits=True)
        self.crops, self.masks = ref_unet.normalize(v["images"]), v["sils"]
        # the crop camera with pixel i's centre at i, as the estimator rounds
        self.K = v["K"].clone()
        self.K[:, 0:2, 2] -= 0.5
        self.cnn_p = weights.unet_params(self.gen, uc)
        self.cnn_p["out.weight"][:12] *= QUERY_GAIN
        self.fit_mask(MASK_LOGIT)
        bake = serve.Driver(self.cfg, {**tr, "down_sample": s["down_sample"], "batch": tr["bake_batch"]}, self.seed,
                            dev)
        bake.crops, bake.masks, bake.cnn_p, bake.gen = self.crops, self.masks, self.cnn_p, self.gen
        self.verts, self.feats = bake.baked_keys(v["points"])
        self.normals = sphere_normals(self.verts).contiguous()
        self.diameter = object_diameter()
        self.crops, self.K, self.gt = self.crops[:V], self.K[:V], (v["R"][:V], v["t"][:V])
        del v, bake, self.masks
        clock.mark("inputs")
        with torch.device(dev):
            self.cnn = ResNetUNet(uc["n_class"], uc["stage_sizes"], uc["widths"], uc["decoder_width"],
                                  getattr(torch, uc["dtype"]))
        self.cnn.load_state_dict(self.cnn_p)
        self.cnn.eval()
        mark = np.zeros(tr["max_requests"], dtype=bool)
        mark[0] = True
        mark[1 + np.random.default_rng(self.seed).choice(tr["check_span"] - 1, size=2, replace=False)] = True
        self.mark = mark
        self.recorder = _Recorder(self.cnn)
        clock.mark("program state")
        self.i = 0
        for _ in range(tr["warmup_requests"]):
            self._request(record=False)
        self.i = 0
        self.latencies, self.answers, self.sampled = [], [], []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def fit_mask(self, level: float):
        """The output layer's mask row fitted by least squares (float64
        normal equations, a little ridge) to +``level`` on the object's
        pixels and -``level`` off it, over every view set-up made, on the
        reference ResNet-UNet's last features (its output layer replaced by
        the identity)."""
        uc, dw = self.cfg["unet"], self.cfg["unet"]["decoder_width"]
        ident = {**self.cnn_p, "out.weight": torch.eye(dw, device=self.dev)[..., None, None],
                 "out.bias": torch.zeros(dw, device=self.dev)}
        AtA = torch.zeros((dw + 1, dw + 1), dtype=torch.float64, device=self.dev)
        Aty = torch.zeros(dw + 1, dtype=torch.float64, device=self.dev)
        no_tf32()
        for a in range(0, self.crops.shape[0], self.tr["bake_batch"]):
            rows = slice(a, a + self.tr["bake_batch"])
            with torch.no_grad():
                h = ref_unet.forward(ident, uc, self.crops[rows], Precision("bfloat16")).reshape(-1, dw).double()
            A = torch.cat([h, torch.ones_like(h[:, :1])], 1)
            AtA += A.T @ A
            Aty += A.T @ torch.where(self.masks[rows].reshape(-1) > 0.5, level, -level).double()
        ridge = 1e-6 * AtA.diagonal().mean()
        w = torch.linalg.solve(AtA + ridge * torch.eye(dw + 1, dtype=torch.float64, device=self.dev), Aty)
        self.cnn_p["out.weight"][12, :, 0, 0] = w[:dw].float()
        self.cnn_p["out.bias"][12] = w[dw].float()

    def _request(self, record: bool = True):
        s = self.s
        with span(self.trace, "surf_eval.feed"):
            row = self.i % self.crops.shape[0]
            draws = self.inf._draw_surfemb(self.gen, self.icfg, self.feats.shape[0], s["refine"])
            keep = record and self.i < len(self.mark) and self.mark[self.i]
            rec = self.recorder.__enter__() if keep else None
        t0 = time.perf_counter()
        with span(self.trace, "surf_eval.estimate"):
            R, t, score = self.inf.estimate_pose_surfemb(
                self.cnn, self.crops[row], self.K[row], self.verts, self.normals, self.feats, self.diameter,
                cfg=self.icfg, refine=s["refine"], refine_steps=s["refine_steps"],
                translation_only=s["translation_only"], draws=draws)
            R_h, t_h = R.cpu(), t.cpu()
        latency = time.perf_counter() - t0
        if keep:
            self.recorder.__exit__()
            self.sampled.append({"row": row, "u": draws.u, "pick": draws.pick, "sel": draws.sel, "R": R, "t": t,
                                 **rec})
        self.i += 1
        return latency, R_h, t_h, score

    # ------------------------------------------------------------ window
    def step(self) -> int:
        latency, R, t, score = self._request()
        self.latencies.append(latency)
        self.answers.append((R, t, score))
        return 1

    def failed(self) -> int:
        """Requests whose pose did not come back whole and finite."""
        return sum(1 for R, t, score in self.answers
                   if R.shape != (3, 3) or t.shape != (3,) or not (torch.isfinite(R).all() and torch.isfinite(t).all()
                                                                  and math.isfinite(score)))

    def end_to_end(self, window_s: float, work: int) -> dict:
        return {"infer_images_per_s": work / window_s}

    def release(self):
        self.cnn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference_maps(self, row: int, precision: str) -> torch.Tensor:
        """The reference ResNet-UNet's maps (S, S, 13) of crop ``row``."""
        no_tf32()
        with torch.no_grad():
            return ref_unet.forward(self.cnn_p, self.cfg["unet"], self.crops[row][None], Precision(precision))[0]

    def reference_queries(self, rows, precision: str) -> torch.Tensor:
        """The reference ResNet-UNet's query map at the stride, (B, Sd^2, 12),
        as ``serve.py`` bakes keys from it."""
        no_tf32()
        ds = self.s["down_sample"]
        with torch.no_grad():
            maps = ref_unet.forward(self.cnn_p, self.cfg["unet"], self.crops[rows], Precision(precision))
        q = maps[:, ::ds, ::ds, :12]
        return q.reshape(q.shape[0], -1, 12)

    def own_answer(self, row: int, maps: torch.Tensor, rec: dict) -> dict:
        """The reference's answer from ``maps`` with ``rec``'s draws."""
        return ref.pose_of_crop(maps, self.verts, self.normals, self.feats, self.diameter, self.K[row], rec["u"],
                                rec["pick"], rec["sel"], self.s)

    def reference_terms(self, maps: torch.Tensor, row: int) -> tuple:
        """The reference's mask terms, max-pooled log-probabilities and cdf
        of the maps (S, S, 13) of crop ``row``: (mask log-probability, its
        complement's, corr_log, cdf, Kd, res)."""
        s, ds = self.s, self.s["down_sample"]
        res = maps.shape[0] // ds
        mlp, nlp, mp = ref.mask_terms(maps[..., 12], ds, s["max_pool"])
        corr_log, cdf = ref.distribution(ref.queries_of(maps[..., :12], ds), self.feats, mp, s["alpha"], res,
                                         s["max_pool"])
        return mlp, nlp, corr_log, cdf, ref.downsample_K(self.K[row], ds), res

    def hypothesis_gaps(self, rec: dict, Kd: torch.Tensor, res: int) -> tuple:
        """(``hyp``, ``order``, ``start``) of one sampled request: the
        reference's float64 P3P, root pick and pruning on the program's
        drawn indices and picks against the program's hypotheses; the
        evaluated hypotheses against the program's own survivors in order;
        the refinement's start against the best evaluated one."""
        R_r, t_r, keep_r = ref.hypotheses(rec["idx"], self.feats.shape[0], res, self.verts, self.normals, rec["pick"],
                                          Kd, self.diameter, self.s["dist_2d_min"])
        keep = rec["keep_all"]
        apart = ref.rotation_angle(rec["R_all"], R_r) + (torch.linalg.vector_norm(rec["t_all"].double() - t_r, dim=-1)
                                                         / torch.linalg.vector_norm(t_r, dim=-1).clamp_min(1e-9))
        differs = (keep != keep_r) | (keep & keep_r & ~(apart <= HYP_TOL))
        hyp = float(differs.sum()) / max(int((keep | keep_r).sum()), 1)
        sel = ref.survivors(keep, self.s["max_pose_evaluations"])
        slot = (same(rec["R_e"], rec["R_all"][sel]).flatten(1).all(1) & same(rec["t_e"], rec["t_all"][sel]).all(1)
                & (rec["valid"] == keep[sel]))
        best = torch.argmax(rec["score"])
        start = bool(same(rec["R0"], rec["R_e"][best]).all() and same(rec["t0"], rec["t_e"][best]).all())
        return hyp, float((~slot).double().mean()), 0.0 if start else 1.0

    def numbers(self, rec: dict, pose: bool = False) -> dict:
        """The check's numbers for one sampled request: ``query``, then the
        stages the reference follows from the request's own state
        (``draw``, ``hyp``, ``order``, ``start``, ``score``, ``refine``,
        ``objective``); with ``pose`` also the gap to the reference's own
        answer from the crop alone, which the check does not hold (the
        module's docstring says why)."""
        s, row = self.s, rec["row"]
        maps_ref = self.reference_maps(row, "bfloat16")
        maps = rec["maps"].float()
        query = rel_gap(maps, maps_ref)
        mlp, nlp, corr_log, cdf, Kd, res = self.reference_terms(maps, row)
        draw = ref.mass_off(cdf, rec["u"], rec["idx"])
        moved = float((ref.inverse(cdf, rec["u"]) != rec["idx"]).double().mean()) if pose else None
        del cdf
        hyp, order, start = self.hypothesis_gaps(rec, Kd, res)
        ms, cs = ref.scores(rec["R_e"], rec["t_e"], Kd, self.verts, corr_log, mlp, nlp, res)
        del corr_log
        score = score_gap(torch.where(rec["valid"], ms + cs, torch.full_like(ms, -math.inf)), rec["score"],
                          rec["valid"])
        refine, objective = ref.refined_gaps(rec["R0"], rec["t0"], rec["R"], rec["t"], rec["f"], maps[..., :12],
                                             self.K[row], self.verts, self.feats, rec["sel"], s)
        out = {"query": query, "draw": draw, "hyp": hyp, "order": order, "start": start, "score": score,
               "refine": refine, "objective": objective}
        if pose:
            out["moved"] = moved
            own = self.own_answer(row, maps_ref, rec)
            out["pose"] = pose_gap(rec["R"], rec["t"], own["R_final"], own["t_final"])
        return out

    def check(self, limits: dict) -> list:
        self.release()
        rows = [self.numbers(rec) for rec in self.sampled]
        if not rows:
            return [(n, math.inf, limits[n]) for n in limits]
        return [(n, combine(n, [r[n] for r in rows]), limits[n]) for n in limits]


def combine(name: str, values: list) -> float:
    """One number of the check over the sampled requests: the widest, but
    for ``refine`` the median.  A sound BFGS can stop early: where its 12
    Armijo trials all fail, x, g and H stay, and every later step repeats
    that search; the reference's continuation from there finds what is
    left (on the card 1 sound request of 90 left 6.6 % of the gain).  A
    refinement cut short or left out leaves much on every request.
    ``refine_each`` in the calibration's lines gives each request's
    reading; PERF.md the spread of sound and faulty ones."""
    return statistics.median(values) if name == "refine" else max(values)


def same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: equal, or both NaN."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def score_gap(ref_score: torch.Tensor, score: torch.Tensor, valid: torch.Tensor) -> float:
    """The widest gap between two scorings of the valid hypotheses: 0 where
    both are -inf (no point won a pixel), infinite where one is."""
    a, b = ref_score.double()[valid], score.double()[valid]
    both = torch.isinf(a) & torch.isinf(b) & (a == b)
    gap = torch.where(both, torch.zeros_like(a), (a - b).abs())
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, math.inf), gap)
    return float(gap.max()) if gap.numel() else 0.0


def pose_gap(R, t, R_ref, t_ref) -> float:
    """The rotation angle between R and R_ref plus the translations' gap
    relative to |t_ref|."""
    gap = ref.rotation_angle(R, R_ref) + (torch.linalg.vector_norm(t.double() - t_ref.double())
                                          / torch.linalg.vector_norm(t_ref.double()).clamp_min(1e-9))
    return float(gap) if torch.isfinite(gap) else math.inf


# the calibration's window: long enough to reach every request its check
# takes, the first ``check_span``
CHECK_WINDOW_S = 6.0
CALIBRATION_PARAMS = {"check_span": 4}


def calibration(drv, mode: str, limits: dict, detail: bool = False) -> dict:
    """The check's numbers of one seed, each combined over the sampled
    requests as the check combines them (``combine``; ``refine_each``
    each request's ``refine``).  "control": the reference with its ResNet-UNet computed a
    precision lower (fp8) in the program's place, through its own
    distribution, hypotheses, scoring and refinement: ``query`` and
    ``pose``; and the reference's scoring a precision lower (the gathered
    log-probabilities and mask terms rounded to bf16) against its own, on
    the program's evaluated hypotheses: ``score`` (the other stage numbers
    follow the control's own state, which it computes as the reference
    does)."""
    drv.release()
    rows = []
    for rec in drv.sampled:
        if mode != "control":
            rows.append(drv.numbers(rec, pose=True))
            continue
        maps_r = drv.reference_maps(rec["row"], "bfloat16")
        maps_c = drv.reference_maps(rec["row"], "fp8")
        mlp, nlp, corr_log, cdf, Kd, res = drv.reference_terms(maps_r, rec["row"])
        del cdf
        low = [x.to(torch.bfloat16).to(x.dtype) for x in (corr_log, mlp, nlp)]
        both = [ref.scores(rec["R_e"], rec["t_e"], Kd, drv.verts, c, m, n, res)
                for c, m, n in ((corr_log, mlp, nlp), low)]
        del corr_log, low
        total = [torch.where(rec["valid"], ms + cs, torch.full_like(ms, -math.inf)) for ms, cs in both]
        mine, own = drv.own_answer(rec["row"], maps_c, rec), drv.own_answer(rec["row"], maps_r, rec)
        rows.append({"query": rel_gap(maps_c, maps_r), "score": score_gap(total[1], total[0], rec["valid"]),
                     "pose": pose_gap(mine["R_final"], mine["t_final"], own["R_final"], own["t_final"])})
    if not rows:
        return {"requests": 0}
    out = {n: combine(n, [r[n] for r in rows]) for n in rows[0]}
    if "refine" in rows[0]:
        out["refine_each"] = [r["refine"] for r in rows]
    return {**out, "requests": len(rows)}


def f32_cumsum(x: torch.Tensor) -> torch.Tensor:
    """A float32 running sum of the flat ``x``: ``torch.cumsum`` on the card
    (a float32 scan); on the CPU, where ``torch.cumsum`` accumulates float32
    in float64, numpy's sequential float32 running sum."""
    if x.device.type == "cuda":
        return torch.cumsum(x.reshape(-1), 0)
    return torch.from_numpy(np.cumsum(x.reshape(-1).numpy(), dtype=np.float32))


def _f32_cdf():
    """The published cdf: one float32 cumulative sum over the flat pixel x
    key array, in the program's place."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf

    def make(orig):
        def distribution(queries, keys, mask_prob, alpha):
            corr_log, cdf = orig(queries, keys, mask_prob, alpha)
            del cdf
            flat = f32_cumsum((torch.exp(corr_log) * mask_prob[:, None]) ** alpha)
            return corr_log, (flat / flat[-1]).view(corr_log.shape)
        return distribution
    return faults.patch(pose_est_surf, "correspondence_distribution", make)


def _half_scored():
    """Half of the evaluated hypotheses scored (every other one), the rest
    -inf."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf

    def make(orig):
        def score_poses(R, t, *a, **k):
            ms, cs = orig(R[::2], t[::2], *a, **k)
            out_m = torch.full((R.shape[0],), -math.inf, device=ms.device)
            out_c = out_m.clone()
            out_m[::2], out_c[::2] = ms, cs
            return out_m, out_c
        return score_poses
    return faults.patch(pose_est_surf, "score_poses", make)


def _no_refine():
    """Refinement that returns its start (no BFGS step), with the objective
    there."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine

    def make(orig):
        def refine_pose(*a, **k):
            return orig(*a, **{**k, "n_steps": 0})
        return refine_pose
    return faults.patch(pose_refine, "refine_pose", make)


def _altered_pose():
    """The answer altered where it is produced: the refined rotation turned
    by 0.05 rad about z."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine

    def make(orig):
        def refine_pose(*a, **k):
            R, t, f = orig(*a, **k)
            c, s = math.cos(0.05), math.sin(0.05)
            Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], device=R.device)
            return Rz @ R, t, f
        return refine_pose
    return faults.patch(pose_refine, "refine_pose", make)


def _no_prune():
    """No pruning: every hypothesis with a valid P3P root kept."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf

    def make(orig):
        def solve_and_prune(p3d, p2d, n3d, u_pick, Kd, **k):
            R, t, _ = orig(p3d, p2d, n3d, u_pick, Kd, **k)
            _, _, valid4 = pnp.solve_p3p_batch(p3d[:, :3], p2d[:, :3], Kd)
            return R, t, valid4.any(1)
        return solve_and_prune
    return faults.patch(pose_est_surf, "_solve_and_prune", make)


def _wrong_root():
    """The valid P3P root of the least pick uniform taken, not of the
    largest."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf

    def make(orig):
        def solve_and_prune(p3d, p2d, n3d, u_pick, Kd, **k):
            return orig(p3d, p2d, n3d, 1.0 - u_pick, Kd, **k)
        return solve_and_prune
    return faults.patch(pose_est_surf, "_solve_and_prune", make)


def _second_best():
    """The refinement started from the second best evaluated hypothesis:
    ``inference``'s ``torch.argmax`` gives the second largest."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference

    class SecondBest:
        def __init__(self, orig):
            self.orig = orig

        def __getattr__(self, name):
            return getattr(self.orig, name)

        def argmax(self, x):
            return self.orig.topk(x, 2).indices[1]
    return faults.patch(inference, "torch", SecondBest)


def _short_bfgs():
    """The refinement cut short: 5 BFGS steps of the configured 50."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine

    def make(orig):
        def refine_pose(*a, **k):
            return orig(*a, **{**k, "n_steps": 5})
        return refine_pose
    return faults.patch(pose_refine, "refine_pose", make)


FAULTS = {"fault_f32_cdf": _f32_cdf, "fault_no_prune": _no_prune, "fault_wrong_root": _wrong_root,
          "fault_half_scored": _half_scored, "fault_second_best": _second_best, "fault_no_refine": _no_refine,
          "fault_short_bfgs": _short_bfgs, "fault_altered_pose": _altered_pose}
