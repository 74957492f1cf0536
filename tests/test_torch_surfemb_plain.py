"""The port's SurfEmb estimator against the benchmark's plain reference
(``portbench/reference/surfemb.py``: float64 distribution and P3P, float32
scoring and refinement), on the CPU at a small size of the benchmark's own
scene: 48 px crops of the analytic object, a ResNet-UNet of random weights
from the seed with its output layer set as ``drivers/surf_eval.py`` sets
it, about 600 keys baked from the reference's queries, 200 hypotheses, 50
scored, 4 BFGS steps.  Every comparison runs on the port's own maps (its
CNN's output), so the two differ only where their arithmetic does."""

import math

import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.cameras import downsample_K
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf as pes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine
from portbench.harness import runner
from portbench.reference import pnp as ref_pnp
from portbench.reference import surfemb as ref

torch.set_num_threads(1)

SMALL = dict(max_poses=200, max_pose_evaluations=50, refine_steps=4)
SCENE = dict(views=6, image_size=48, n_keys=600, bake_batch=6, check_span=4)
SEEDS = [2**31 + 977, 7]


def _driver(seed: int):
    cell = runner.Cell("surfemb.surf-eval")
    cell.config["surfemb"].update(SMALL)
    cell.traffic["params"].update(SCENE)
    _, drv = cell.driver(seed, "cpu")
    drv.setup()
    return drv


@pytest.fixture(scope="module", params=SEEDS, ids=["seed0", "seed1"])
def case(request):
    """The small scene of one seed, the port's maps of its first crop and
    that image's draws."""
    drv = _driver(request.param)
    row = 0
    with torch.no_grad():
        maps = drv.cnn(drv.crops[row][None])[0]
    g = torch.Generator().manual_seed(request.param % 1000)
    draws = inference._draw_surfemb(g, drv.icfg, drv.feats.shape[0], True)
    return {"drv": drv, "row": row, "maps": maps, "draws": draws, "s": drv.s, "K": drv.K[row]}


def _port_distribution(case):
    s, maps = case["s"], case["maps"]
    res = maps.shape[0] // s["down_sample"]
    mlp, nlp, mp = pes.mask_terms(maps[..., 12], s["down_sample"])
    q = pes._avg_pool(maps[..., :12], s["down_sample"]).reshape(res * res, -1)
    corr_log, cdf = pes.correspondence_distribution(q, case["drv"].feats, mp, s["alpha"])
    return pes._max_pool_3x3_keys(corr_log, res), cdf, (mlp, nlp, mp), res


def _ref_distribution(case):
    s, maps = case["s"], case["maps"]
    res = maps.shape[0] // s["down_sample"]
    mlp, nlp, mp = ref.mask_terms(maps[..., 12], s["down_sample"])
    corr_log, cdf = ref.distribution(ref.queries_of(maps[..., :12], s["down_sample"]), case["drv"].feats, mp,
                                     s["alpha"], res)
    return corr_log, cdf, (mlp, nlp, mp), res


def test_mask_terms_and_distribution_match(case):
    """Mask terms to 1e-6; the pooled log-softmax to 1e-5 of its scale
    (float32 against float64); both cdfs monotone, ending at 1, and within
    1e-6 of each other."""
    pc, pcdf, pm, _ = _port_distribution(case)
    rc, rcdf, rm, _ = _ref_distribution(case)
    for a, b in zip(pm, rm):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    scale = float(rc.abs().max())
    assert float((pc.double() - rc).abs().max()) <= 1e-5 * scale
    pcdf = pcdf.view(-1)
    assert float(pcdf[-1]) == 1.0 and float(rcdf[-1]) == 1.0
    assert bool((pcdf[1:] >= pcdf[:-1]).all()) and bool((rcdf[1:] >= rcdf[:-1]).all())
    assert float((pcdf - rcdf).abs().max()) <= 1e-6


def test_drawn_indices_equal(case):
    """The port's two-level cdf draws the (pixel, key) index that the exact
    float64 cdf draws, for every one of the 800 uniforms."""
    _, pcdf, _, _ = _port_distribution(case)
    _, rcdf, _, _ = _ref_distribution(case)
    u = case["draws"].u
    torch.testing.assert_close(pes.inverse_cdf(pcdf, u), ref.inverse(rcdf, u), atol=0, rtol=0)


def test_hypotheses_and_scores_on_shared_poses(case):
    """The port's evaluated hypotheses: the reference's float64 P3P on the
    same draws keeps the same survivors but for ill-posed triples (at most
    5 %); the reference scores the port's poses as the port does, to 1e-5
    (mask and coord scores, -inf where no point won a pixel)."""
    drv, s = case["drv"], case["s"]
    maps, K = case["maps"], case["K"]
    got = pes.estimate_pose(maps[..., 12], maps[..., :12], drv.verts, drv.normals, drv.feats, drv.diameter, K,
                            max_poses=s["max_poses"], max_pose_evaluations=s["max_pose_evaluations"],
                            alpha=s["alpha"], dist_2d_min=s["dist_2d_min"],
                            draws=pes.HypothesisDraws(case["draws"].u, case["draws"].pick))
    corr_log, cdf, (mlp, nlp, _), res = _ref_distribution(case)
    idx = ref.inverse(cdf, case["draws"].u)
    _, _, keep = ref.hypotheses(idx, drv.feats.shape[0], res, drv.verts, drv.normals, case["draws"].pick,
                                ref.downsample_K(K, s["down_sample"]), drv.diameter, s["dist_2d_min"])
    sel = ref.survivors(keep, s["max_pose_evaluations"])
    assert float((keep[sel] != got.valid).double().mean()) <= 0.05
    assert int(got.valid.sum()) >= 10
    ms, cs = ref.scores(got.R, got.t, downsample_K(K, s["down_sample"]), drv.verts, corr_log, mlp, nlp, res)
    torch.testing.assert_close(got.mask_scores.double(), ms, atol=1e-5, rtol=0)
    fin = torch.isfinite(cs)
    assert bool((torch.isfinite(got.coord_scores) == fin).all()) and int(fin.sum()) >= 10
    torch.testing.assert_close(got.coord_scores.double()[fin], cs[fin], atol=1e-5, rtol=0)


def test_refined_objective_from_a_shared_start(case):
    """From the port's best hypothesis and its key permutation, 4 BFGS
    steps: the port's refined pose is the reference's to 1e-4 (R) and 1e-4
    of |t| (t), and the reference's objective there is its own to 1e-5
    relative; the start moved."""
    drv, s, maps, K = case["drv"], case["s"], case["maps"], case["K"]
    R_b, t_b, _ = inference.estimate_pose_surfemb(drv.cnn, drv.crops[case["row"]], K, drv.verts, drv.normals,
                                                  drv.feats, drv.diameter, cfg=drv.icfg, refine=False,
                                                  draws=case["draws"])
    sel = case["draws"].sel
    R, t, f = pose_refine.refine_pose(R_b, t_b, maps[..., :12], K, drv.verts, drv.feats, n_steps=s["refine_steps"],
                                      sel=sel)
    R_r, t_r, f_r, obj = ref.refine(R_b, t_b, maps[..., :12], K, drv.verts, drv.feats, sel, s)
    torch.testing.assert_close(R, R_r, atol=1e-4, rtol=0)
    assert float((t - t_r).abs().max()) <= 1e-4 * float(t_r.norm())
    f_at = float(obj(R[None], t[None])[0])
    assert math.isfinite(f_at) and abs(f_at - float(f_r)) <= 1e-5 * abs(float(f_r))
    assert abs(float(f) - float(f_r)) <= 1e-5 * abs(float(f_r))
    assert float((t - t_b).abs().max()) > 0


def well_posed(case, tol: float = 1e-3):
    """The case's draws with each hypothesis whose P3P triple is ill-posed
    (the port's float32 roots and the reference's float64 roots differ in
    validity, or by more than ``tol`` in R or ``tol`` of |t| in t) replaced
    by a well-posed one, in turn; and the number replaced.  On random draws
    many triples are ill-posed, and there float32 Grunert moves its roots
    far (the port's own CPU-card test says so too)."""
    drv, s, K = case["drv"], case["s"], case["K"]
    _, cdf, _, res = _ref_distribution(case)
    d = case["draws"]
    idx = ref.inverse(cdf, d.u)
    m = drv.feats.shape[0]
    p2i, p3i = idx // m, idx % m
    p2d = torch.stack([p2i % res, p2i // res], -1).float()
    Kd = downsample_K(K, s["down_sample"])
    Rp, tp, vp = pnp.solve_p3p_batch(drv.verts[p3i[:, :3]], p2d[:, :3], Kd)
    Rr, tr, vr = ref_pnp.p3p(drv.verts.double()[p3i[:, :3]], ref_pnp.bearings(p2d[:, :3].double(), Kd.double()))
    both = vp & vr
    dR = torch.where(both[..., None, None], (Rp.double() - Rr).abs(), torch.zeros_like(Rr)).amax((1, 2, 3))
    dt = torch.where(both[..., None], (tp.double() - tr).abs(), torch.zeros_like(tr)).amax((1, 2))
    t_max = float(torch.where(vr[..., None], tr.abs(), torch.zeros_like(tr)).max())
    good = (vp == vr).all(1) & (dR < tol) & (dt < tol * t_max)
    fill = torch.nonzero(good)[:, 0]
    rep = torch.where(good, torch.arange(good.shape[0]), fill[torch.arange(good.shape[0]) % fill.shape[0]])
    return inference.SurfEmbDraws(d.u[rep], d.pick[rep], d.sel), int((~good).sum())


def test_estimate_pose_surfemb_matches_reference(case):
    """The whole single-image path on the port's maps, on well-posed draws
    (``well_posed``: at most half replaced): unrefined, the best hypothesis
    is the reference's (score to 1e-4, R to 1e-3 and t to 1e-3 of |t|:
    float32 against float64 P3P); refined, the answer is the reference's
    refinement of the port's best to 1e-4 (R) and 1e-4 of |t| (t).  From
    the reference's own best, 1e-3 away, four BFGS steps can land 0.1
    apart: the line search's first passing trial flips."""
    drv, s = case["drv"], case["s"]
    draws, replaced = well_posed(case)
    assert replaced <= s["max_poses"] // 2
    args = (drv.cnn, drv.crops[case["row"]], case["K"], drv.verts, drv.normals, drv.feats, drv.diameter)
    R_b, t_b, score = inference.estimate_pose_surfemb(*args, cfg=drv.icfg, refine=False, draws=draws)
    R, t, score_r = inference.estimate_pose_surfemb(*args, cfg=drv.icfg, refine_steps=s["refine_steps"], draws=draws)
    want = ref.pose_of_crop(case["maps"], drv.verts, drv.normals, drv.feats, drv.diameter, case["K"], draws.u,
                            draws.pick, draws.sel, s)
    assert math.isfinite(score) and score_r == score
    assert abs(score - float(want["score"][want["best"]])) <= 1e-4
    torch.testing.assert_close(R_b.double(), want["R_best"].double(), atol=1e-3, rtol=0)
    assert float((t_b - want["t_best"]).abs().max()) <= 1e-3 * float(want["t_best"].norm())
    R_r, t_r, _, _ = ref.refine(R_b, t_b, case["maps"][..., :12], case["K"], drv.verts, drv.feats, draws.sel, s)
    torch.testing.assert_close(R, R_r, atol=1e-4, rtol=0)
    assert float((t - t_r).abs().max()) <= 1e-4 * float(t_r.norm())
