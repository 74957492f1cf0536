"""Driver of per-image pose estimation: the program's
``pipeline/inference.py`` ``estimate_poses`` on requests of ``batch``
crops, one request a unit of work, one caller that waits for each answer.

Set-up makes a sequence of ``views`` crops of the analytic object
(ImageNet-normalized, with masks and intrinsics) and as many views more,
the ResNet-UNet's weights, and ``n_keys`` baked keys with their surface
points, all from the seed on the card: the reference ResNet-UNet's queries
at every object pixel of the sequence on the stride's grid, and at pixels
of the other views (``Driver.baked_keys``).  It warms the path with a few
requests.  The window sends the crops in turn, ``batch`` a request, with
the RANSAC draws from the benchmark's generator, and times each request
from the call to its poses on the host.

The check takes a sample of the window's requests, drawn from the seed.
The reference makes each request's answer from the crops alone: its
ResNet-UNet's queries, exact float64 logits over every key, its
confidence filter, and RANSAC in float64 with the hypotheses drawn as the
request drew them; against it, the program's served correspondences
(``match``, ``keep``) and poses (``pose``).  It also holds each of the
program's stages to the reference on the program's own inputs: the query
maps (``query``), K3's argmax and confidences against exact logits on the
program's queries (``argmax``, ``conf``), and the confidence filter on
the program's confidences (``filter``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness import clock, faults, scene, weights
from portbench.harness.trace import span
from portbench.reference import pnp as ref_pnp
from portbench.reference import unet as ref_unet
from portbench.reference.precision import Precision, no_tf32

SPANS = ("serve.",)


class _Recorder:
    """Records, for one request that the check samples, what the program
    hands between its stages: the queries K3 gets, its answer, and the
    confidence filter's inputs.  Installed around that request alone; it
    keeps references to the program's tensors, which nothing writes
    afterwards, and copies nothing."""

    def __init__(self):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import similarity

        self.mod, self.rec = similarity, {}
        self.orig = (similarity.correspondence_argmax, similarity.confidence_threshold)

    def corr(self, q, k):
        idx, conf = self.orig[0](q, k)
        self.rec.update(q=q, idx=idx, conf=conf)
        return idx, conf

    def thresh(self, conf, valid, keep_frac=0.8):
        self.rec.update(valid=valid)
        return self.orig[1](conf, valid, keep_frac)

    def __enter__(self):
        self.rec = {}
        self.mod.correspondence_argmax, self.mod.confidence_threshold = self.corr, self.thresh
        return self.rec

    def __exit__(self, *exc):
        self.mod.correspondence_argmax, self.mod.confidence_threshold = self.orig


class Driver:
    def __init__(self, cfg: dict, tr: dict, seed: int, device, trace: bool = False):
        self.cfg, self.tr, self.seed, self.dev, self.trace = cfg, tr, seed, torch.device(device), trace
        self.latencies, self.answers, self.sampled = [], [], []

    def setup(self):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference

        self.inf = inference
        tr, uc, dev = self.tr, self.cfg["unet"], self.dev
        self.gen = torch.Generator(device=dev).manual_seed(self.seed)
        V = tr["views"]
        v = scene.views(self.gen, 2 * V, tr["image_size"], hits=True)
        self.crops, self.masks, self.K = ref_unet.normalize(v["images"]), v["sils"], v["K"]
        self.cnn_p = weights.unet_params(self.gen, uc)
        self.verts, self.feats = self.baked_keys(v["points"])
        self.crops, self.masks, self.K = self.crops[:V], self.masks[:V], self.K[:V]
        del v
        clock.mark("inputs")
        with torch.device(dev):
            self.cnn = ResNetUNet(uc["n_class"], uc["stage_sizes"], uc["widths"], uc["decoder_width"],
                                  getattr(torch, uc["dtype"]))
        self.cnn.load_state_dict(self.cnn_p)
        self.cnn.eval()
        mark = np.random.default_rng(self.seed).random(tr["max_requests"]) < tr["check_share"]
        mark[0] = True
        self.mark = mark
        self.recorder = _Recorder()
        clock.mark("program state")
        self.i = 0
        for _ in range(tr["warmup_requests"]):
            self._request(record=False)
        self.i = 0
        self.latencies, self.answers, self.sampled = [], [], []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def baked_keys(self, points: torch.Tensor):
        """(surface points (n_keys, 3), keys (n_keys, 12)) baked from the
        reference ResNet-UNet's queries at the object pixels on the stride's
        grid, each scaled to norm 3, with the surface point the pixel sees:
        every such pixel of the sequence (the first ``views`` of
        ``points``' views), and pixels drawn from the seed among the other
        views' up to ``n_keys``, in an order drawn from the seed.  A trained
        network's queries match the keys baked at the points it sees; these
        make the random network's do so too, so that RANSAC gets
        correspondences that hold the view's pose."""
        tr, ds, V = self.tr, self.tr["down_sample"], self.tr["views"]
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        qs, ps = [], []
        for a in range(0, self.crops.shape[0], tr["batch"]):
            rows = torch.arange(a, min(a + tr["batch"], self.crops.shape[0]), device=self.dev)
            on = (self.masks[rows][:, ::ds, ::ds] > 0.5).reshape(rows.shape[0], -1)
            qs.append(self.reference_queries(rows, "bfloat16")[on].float())
            ps.append(points[rows][:, ::ds, ::ds].reshape(rows.shape[0], -1, 3)[on])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        seq = int((self.masks[:V, ::ds, ::ds] > 0.5).sum())
        q, p = torch.cat(qs), torch.cat(ps)
        extra = tr["n_keys"] - seq
        if extra < 0 or q.shape[0] - seq < extra:
            raise ValueError(f"the views hold {seq} and {q.shape[0] - seq} grid pixels, not {tr['n_keys']} keys")
        take = torch.cat([torch.arange(seq, device=self.dev),
                          seq + torch.randperm(q.shape[0] - seq, generator=self.gen, device=self.dev)[:extra]])
        take = take[torch.randperm(take.shape[0], generator=self.gen, device=self.dev)]
        q = q[take]
        return p[take].contiguous(), (3.0 * q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).contiguous()

    def _request(self, record: bool = True):
        tr, B = self.tr, self.tr["batch"]
        with span(self.trace, "serve.feed"):
            rows = (torch.arange(B, device=self.dev) + self.i * B) % self.crops.shape[0]
            keep = record and self.i < len(self.mark) and self.mark[self.i]
            state = self.gen.get_state() if keep else None
            rec = self.recorder.__enter__() if keep else None
        t0 = time.perf_counter()
        with span(self.trace, "serve.estimate_poses"):
            est = self.inf.estimate_poses(self.cnn, self.crops[rows], self.masks[rows], self.K[rows], self.verts,
                                          self.feats, down_sample=tr["down_sample"], keep_frac=tr["conf_keep_frac"],
                                          n_hyp=tr["ransac_iters"], reproj_err=tr["reproj_err_px"],
                                          generator=self.gen, mesh=None)
            R, t = est.R.cpu(), est.t.cpu()
        latency = time.perf_counter() - t0
        if keep:
            self.recorder.__exit__()
            self.sampled.append({"rows": rows, "gen": state, "R": R, "t": t, "mask": est.conf_mask, **rec})
        self.i += 1
        return latency, R, t

    # ------------------------------------------------------------ window
    def step(self) -> int:
        latency, R, t = self._request()
        self.latencies.append(latency)
        self.answers.append((R, t))
        return self.tr["batch"]

    def failed(self) -> int:
        """Requests whose poses did not come back whole and finite."""
        B = self.tr["batch"]
        return sum(1 for R, t in self.answers
                   if R.shape != (B, 3, 3) or not (torch.isfinite(R).all() and torch.isfinite(t).all()))

    def end_to_end(self, window_s: float, work: int) -> dict:
        out = {"infer_images_per_s": work / window_s}
        if self.latencies:
            out["infer_batch_p95_ms"] = 1e3 * float(np.percentile(np.asarray(self.latencies), 95))
        return out

    def release(self):
        self.cnn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference_queries(self, rows, precision: str) -> torch.Tensor:
        """The reference ResNet-UNet's query map at the stride, (B, Sd^2, 12)."""
        no_tf32()
        ds = self.tr["down_sample"]
        with torch.no_grad():
            maps = ref_unet.forward(self.cnn_p, self.cfg["unet"], self.crops[rows], Precision(precision))
        q = maps[:, ::ds, ::ds, :12]
        return q.reshape(q.shape[0], -1, 12)

    def exact_logits(self, q: torch.Tensor, chunk: int = 8192):
        """(best logit, log-sum-exp, index of the best key) over every key,
        in float64, for queries (N, 12)."""
        k = self.feats.double()
        best, lse, idx = [], [], []
        for a in range(0, q.shape[0], chunk):
            lg = q[a:a + chunk].double() @ k.T
            m = lg.max(1)
            best.append(m.values)
            idx.append(m.indices)
            lse.append(torch.logsumexp(lg, 1))
        return torch.cat(best), torch.cat(lse), torch.cat(idx)

    def own_answer(self, rows, q: torch.Tensor) -> dict:
        """Correspondences made from queries ``q`` (B, Nq, 12) by the plain
        stages: exact float64 argmax over every key (``idx``, its logit
        ``best``), the confidence filter on the crops' masks (``mask``,
        among the ``valid`` pixels)."""
        ds, (B, Nq) = self.tr["down_sample"], q.shape[:2]
        valid = (self.masks[rows][:, ::ds, ::ds] > 0.5).reshape(B, Nq)
        best, lse, idx = self.exact_logits(q.reshape(-1, 12))
        mask = ref_confidence_filter((best - lse).view(B, Nq), valid, self.tr["conf_keep_frac"])
        return {"rows": rows, "idx": idx.view(B, Nq), "mask": mask, "best": best.view(B, Nq), "valid": valid}

    def served(self, rec: dict, q_ref: torch.Tensor, own: dict) -> dict:
        """The correspondences of ``rec`` (``idx``, ``mask``) judged against
        ``own``, those the reference makes from its own queries ``q_ref``
        (B, Nq, 12): ``match``, the widest gap by which the logit of a key
        served (kept by the filter) lies below the reference's best for that
        pixel, as a share of the largest logit the pixel's query can reach;
        ``keep``, the share of valid pixels that the two filters keep
        differently."""
        k, q = self.feats.double(), q_ref.double()
        at = (q * k[rec["idx"].long()]).sum(-1)
        scale = torch.linalg.vector_norm(q, dim=-1) * torch.linalg.vector_norm(k, dim=-1).max()
        gap = (own["best"] - at) / scale.clamp_min(1e-30)
        served, valid = rec["mask"].bool(), own["valid"]
        match = float(gap[served].max()) if served.any() else 0.0
        keep = float((own["mask"] != served)[valid].double().mean()) if valid.any() else 0.0
        return {"match": match, "keep": keep}

    def reference_pose(self, own: dict, gen_state) -> tuple:
        """The reference RANSAC in float64 on the correspondences ``own``
        (as ``own_answer`` makes them), its hypotheses drawn from the
        generator in ``gen_state`` in proportion to ``own``'s filter, as the
        request draws them: (R (B, 3, 3), t (B, 3)) on the host."""
        tr = self.tr
        B, Nq = own["idx"].shape
        sd = int(math.isqrt(Nq))
        g = torch.Generator(device=self.dev)
        g.set_state(gen_state)
        w = own["mask"].to(torch.float32)
        samples = torch.multinomial(w.clamp_min(1e-12), tr["ransac_iters"] * 4, replacement=True,
                                    generator=g).view(B, tr["ransac_iters"], 4)
        yy = torch.arange(sd, device=self.dev)
        gy, gx = torch.meshgrid(yy, yy, indexing="ij")
        p2d = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).to(torch.float64)
        Kd = self.K[own["rows"]].double()
        Kd[..., 0:2, 2] += 0.5
        Kd[..., 0:2, :] /= tr["down_sample"]
        Kd[..., 0:2, 2] -= 0.5
        R, t = ref_pnp.ransac(self.verts.double()[own["idx"].long()], p2d, Kd, w.double(), samples,
                              tr["reproj_err_px"])
        return R.cpu(), t.cpu()

    def stage_checks(self, rec: dict) -> dict:
        """Each number for one sampled request: the stages the reference
        follows from the program's state (``query``, ``argmax``, ``conf``,
        ``filter``), and the answer it makes from the crops alone through
        its own stages (``match``, ``keep``, ``pose``)."""
        tr = self.tr
        q_ref = self.reference_queries(rec["rows"], "bfloat16")
        own = self.own_answer(rec["rows"], q_ref)
        q = rec["q"].reshape(q_ref.shape)
        query = float(torch.linalg.vector_norm(q.double() - q_ref.double()) / torch.linalg.vector_norm(q_ref.double()))
        flat = rec["q"].reshape(-1, 12)
        best, lse, _ = self.exact_logits(flat)
        mine = (flat.double() * self.feats.double()[rec["idx"].reshape(-1).long()]).sum(-1)
        argmax = float((best - mine).max())
        conf = float((rec["conf"].reshape(-1).double() - (best - lse)).abs().max())
        mask = ref_confidence_filter(rec["conf"], rec["valid"], tr["conf_keep_frac"])
        filt = float((mask != rec["mask"].bool()).sum())
        pose = pose_gap(rec["R"], rec["t"], *self.reference_pose(own, rec["gen"]))
        return {"query": query, "argmax": argmax, "conf": conf, "filter": filt, "pose": pose,
                **self.served(rec, q_ref, own)}

    def check(self, limits: dict) -> list:
        self.release()
        return checks_of([self.stage_checks(rec) for rec in self.sampled], limits)


def pose_gap(R, t, R_ref, t_ref) -> float:
    """The widest gap over a request's images between poses and the
    reference's: the Frobenius norm of the rotations' difference plus the
    translations' gap relative to the reference's."""
    R, t, R_ref, t_ref = R.double(), t.double(), R_ref.double(), t_ref.double()
    gap = torch.linalg.matrix_norm(R - R_ref) + (torch.linalg.vector_norm(t - t_ref, dim=-1)
                                                 / torch.linalg.vector_norm(t_ref, dim=-1).clamp_min(1e-9))
    return float(gap.max()) if torch.isfinite(gap).all() else math.inf


def ref_confidence_filter(conf, valid, keep_frac: float):
    """Valid entries at or above the (1 - keep_frac) quantile of the valid
    confidences along the last axis."""
    n_valid = valid.sum(-1, keepdim=True).clamp_min(1)
    k = torch.floor((1.0 - keep_frac) * n_valid).to(torch.int64)
    s = torch.sort(torch.where(valid, conf, torch.full_like(conf, float("inf"))), dim=-1).values
    return valid & (conf >= s.gather(-1, k.clamp(0, conf.shape[-1] - 1)))


def checks_of(per_request: list, limits: dict) -> list:
    """The widest reading of each stage over the sampled requests; none
    sampled reads infinite."""
    names = tuple(limits)
    if not per_request:
        return [(n, math.inf, limits[n]) for n in names]
    return [(n, max(r[n] for r in per_request), limits[n]) for n in names]


# the calibration's window, and the share of its requests checked: about
# as many as a run of 51 s checks (3 % of some 800)
CHECK_WINDOW_S = 2.0
CALIBRATION_PARAMS = {"check_share": 0.75}


def calibration(drv, mode: str, limits: dict, detail: bool = False) -> dict:
    """The check's numbers of one seed, each the widest over the sampled
    requests.  "control": the reference with its ResNet-UNet computed a
    precision lower (fp8) in the program's place, through its own argmax,
    filter and RANSAC: ``query``, ``match``, ``keep`` and ``pose`` (the
    other stages follow the program's state, which the control has none
    of)."""
    drv.release()
    rows = []
    for rec in drv.sampled:
        if mode != "control":
            rows.append(drv.stage_checks(rec))
            continue
        q_r = drv.reference_queries(rec["rows"], "bfloat16")
        q_c = drv.reference_queries(rec["rows"], "fp8")
        own_r, own_c = drv.own_answer(rec["rows"], q_r), drv.own_answer(rec["rows"], q_c)
        gap = float(torch.linalg.vector_norm(q_c.double() - q_r.double()) / torch.linalg.vector_norm(q_r.double()))
        R_c, t_c = drv.reference_pose(own_c, rec["gen"])
        rows.append({"query": gap, **drv.served(own_c, q_r, own_r),
                     "pose": pose_gap(R_c, t_c, *drv.reference_pose(own_r, rec["gen"]))})
    if not rows:
        return {"requests": 0}
    return {**{n: max(r[n] for r in rows) for n in rows[0]}, "requests": len(rows)}


def _altered_pose():
    """An answer altered where it is produced: the first image's rotation
    turned by 0.05 rad about z after RANSAC."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp

    def make(orig):
        def ransac(*a, **k):
            res = orig(*a, **k)
            c, s = math.cos(0.05), math.sin(0.05)
            Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], device=res.R.device)
            R = res.R.clone()
            R[0] = Rz @ R[0]
            return res._replace(R=R)
        return ransac
    return faults.patch(pnp, "ransac_pnp", make)


def _altered_match():
    """A correspondence altered where it is produced: K3's answer for every
    hundredth query moved to the next key, its confidence lowered by 0.01."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import similarity

    def make(orig):
        def corr(q, k):
            idx, conf = orig(q, k)
            idx, conf = idx.clone(), conf.clone()
            idx.view(-1)[::100] = (idx.view(-1)[::100] + 1) % k.shape[0]
            conf.view(-1)[::100] -= 0.01
            return idx, conf
        return corr
    return faults.patch(similarity, "correspondence_argmax", make)


FAULTS = {"fault_pose": _altered_pose, "fault_match": _altered_match}
