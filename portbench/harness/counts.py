"""The table of peaks and the operation / byte counts the per-layer
metrics divide by.  Every count follows from the shapes the cell's
configuration and traffic state, never from what the program reports.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32 off
them (an FMA counted as two), 3.35 TB/s of device memory; and at the 1.98
GHz boost clock on 132 SMs, 16 special-function results (an exponential)
an SM a clock.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SFU_OPS = 132 * 16 * 1.98e9


def bound_s(n_bytes: float, n_ops: float, rate: float) -> float:
    """The least time: the larger of bytes over the memory rate and
    operations over their peak."""
    return max(n_bytes / HBM_BPS, n_ops / rate)


def field_dims(fc: dict):
    """(E, nh): the embedding's sin (or cos) width 3 H and the hidden width."""
    return 3 * fc["n_harmonic_functions"], fc["n_hidden"]


def k4_flops(E: int, nh: int) -> dict:
    """bf16 product FLOPs of K4's work, by shapes (as the port's kernel
    table counts them): a point's forward (trunk and colour products), its
    backward (two cotangent products, four weight-grad contractions), and a
    ray's direction part (forward) or its grads (backward)."""
    return {"fwd": 4 * E * nh + 4 * nh * nh, "bwd": 4 * E * nh + 8 * nh * nh, "ray": 4 * E * nh}


def k4_weight_bytes(E: int, nh: int) -> int:
    """f32 bytes of K4's 13 weight blocks (or of their grads)."""
    return 4 * (4 * E * nh + 2 * nh * nh + 7 * nh + 4)


def k4_pass(H: int, R: int, P: int, E: int, nh: int, want_weights: bool):
    """(bytes, FLOPs) of one K4 pass over H halves x R rays x P points:
    points (and EA weights) out and in once, a ray's direction and targets,
    each half's weights read and grads written."""
    n_pts = H * R * P
    ff = k4_flops(E, nh)
    n_bytes = n_pts * (12 + 4 * want_weights) + H * R * (12 + 32) + 2 * H * k4_weight_bytes(E, nh)
    return n_bytes, n_pts * (ff["fwd"] + ff["bwd"]) + H * R * 2 * ff["ray"]


def nerf_shapes(tr: dict) -> dict:
    """A NeRF step's halves, rays a half and points a ray of each pass."""
    R = tr["cams_per_step"] * tr["rays_per_image"]
    Pf = tr["n_pts_fine"] + (tr["n_pts_coarse"] if tr["add_input_samples"] else 0)
    return {"H": tr["halves"], "R": R, "Pc": tr["n_pts_coarse"], "Pf": Pf}


def field_step_flops(fc: dict, tr: dict) -> float:
    """Forward and backward FLOPs of a NeRF step's field passes: every
    Dense of trunk, density and colour heads at every point (the colour
    layer's direction part once a ray); backward = the weight grads of
    every layer plus the input grads of every layer but the first and the
    direction part."""
    E, nh = field_dims(fc)
    s = nerf_shapes(tr)
    emb = 2 * E
    per_pt = 2 * (emb * nh + nh * nh + nh + nh * nh + 3 * nh)       # trunk1, trunk2, density, colour h-part, colour2
    per_pt_dgrad = 2 * (nh * nh + nh + nh * nh + 3 * nh)             # all but trunk1's input grad
    per_ray = 2 * emb * nh                                           # colour direction part
    pts = s["H"] * s["R"] * (s["Pc"] + s["Pf"])
    rays = s["H"] * s["R"] * 2
    return pts * (2 * per_pt + per_pt_dgrad) + rays * 2 * per_ray


def _conv_out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def unet_conv_flops(uc: dict, B: int, S: int) -> list:
    """Forward FLOPs of each of the ResNet-UNet's convolutions on B images
    of S x S (2 Cout Cin k^2 Hout Wout), the stem first."""
    convs = []                                           # (cin, cout, k, out size)
    s0 = _conv_out(S, 7, 2)
    convs.append((3, 64, 7, s0))
    n, cin = _conv_out(s0, 3, 2), 64
    skips = [(s0, 64)]
    for i, (blocks, w) in enumerate(zip(uc["stage_sizes"], uc["widths"])):
        for j in range(blocks):
            stride = 2 if (j == 0 and i > 0) else 1
            m = _conv_out(n, 3, stride)
            convs += [(cin, w, 3, m), (w, w, 3, m)]
            if cin != w or stride != 1:
                convs.append((cin, w, 1, m))
            n, cin = m, w
        skips.append((n, w))
    ch, dw = skips[-1][1], uc["decoder_width"]
    for size, sc in reversed(skips[:-1]):
        convs.append((ch + sc, 2 * dw, 3, size))
        ch = 2 * dw
    convs += [(2 * dw, dw, 3, S), (dw, uc["n_class"], 1, S)]
    return [2 * ci * co * k * k * m * m * B for ci, co, k, m in convs]


def unet_flops(uc: dict, B: int, S: int) -> float:
    """Forward and backward FLOPs of the ResNet-UNet's convolutions: the
    backward takes the weight grads of every convolution and the input
    grads of all but the stem's."""
    fwd = unet_conv_flops(uc, B, S)
    return 3 * sum(fwd) - fwd[0]


def key_head_flops(fc: dict, n_points: int) -> float:
    """Forward and backward FLOPs of the key head at n_points points
    (backward: weight grads of every layer, input grads of all but the
    first)."""
    nh, fd, emb = fc["n_hidden"], fc["feature_dim"], 6 * fc["n_harmonic_functions"]
    if fc["siren"]:
        fwd, dgrad = 2 * (3 * nh + 2 * nh * nh + nh * fd), 2 * (2 * nh * nh + nh * fd)
    else:
        fwd, dgrad = 2 * (emb * nh + nh * fd), 2 * nh * fd
    return n_points * (2 * fwd + dgrad)


def pose_step_flops(cfg: dict, tr: dict) -> float:
    """A descriptor step's forward and backward FLOPs: the ResNet-UNet on
    the batch, the key head at the positives and the negatives, and
    InfoNCE's query-negative products."""
    B, n, S, E = tr["batch_size"], tr["sample_size"], tr["image_size"], cfg["field"]["feature_dim"]
    return unet_flops(cfg["unet"], B, S) + key_head_flops(cfg["field"], 2 * B * n) + 3 * 2 * B * n * n * E


def serve_queries(tr: dict) -> int:
    """Queries a request sends to K3: each crop's query map at the
    down-sampling stride."""
    sd = -(-tr["image_size"] // tr["down_sample"])
    return tr["batch"] * sd * sd


def k3_least_s(n: int, m: int, e: int) -> float:
    """K3's least time for n queries against m keys of width e: the larger
    of its logits' 2 e FLOPs a pair at the f32 peak, one exponential a pair
    on the special-function units, and its bytes (queries and keys read,
    index and confidence written) at the memory rate."""
    return max(bound_s(4 * e * (n + m) + 8 * n, 2 * n * m * e, F32_FLOPS), n * m / SFU_OPS)


def serve_request_flops(cfg: dict, tr: dict) -> float:
    """A request's forward FLOPs: the ResNet-UNet on its crops and the
    similarity products of its queries against every key."""
    fwd = unet_conv_flops(cfg["unet"], tr["batch"], tr["image_size"])
    return sum(fwd) + 2 * serve_queries(tr) * tr["n_keys"] * cfg["field"]["feature_dim"]
