#!/usr/bin/env python3
"""Time the kernels of two checkouts with one timer on one NVIDIA card.

    python3 kernel_ab.py OTHER_CHECKOUT

Builds ``refign_tpu_torch/csrc/{sra_attention,dwconv3x3_gelu,
local_correlation,sra_attention_backward,dwconv3x3_gelu_backward,
local_correlation_backward}.cu`` of
this checkout and of OTHER_CHECKOUT (for example a ``git archive`` of the
parent commit) with the same nvcc flags, calls each kernel straight
through its C entry point (no Python wrapper, so no host time) at the
shapes of ``chip_smoke.py`` (K1, K2: the four MiT-B5 stages; K3: the three
UAWarpC levels, raw fp32 mode, with the source as the NHWC view of an NCHW
tensor; K1 and K2 backward: the four stages of a train-step pass, bf16;
K3 backward: the stage-1 UAWarpC step's three levels, fused bf16 with both
gradients and with gs alone as the path asks), checks each output against
the plain version within ``chip_smoke.py``'s limit (bf16 for K1 and K2,
1e-5 for K3, the gradient limits against fp32 autograd for the
backwards), and prints the times of the runs other, this, this, other,
then the best of each checkout per shape.  For K3's backward it also
prints, in the first run of each checkout, how many elements pass only by
the limit's bf16 allowance on jump (``chip_smoke.corr_grad_limit``).  An output beyond its limit is
printed once (for this checkout's K3 backward with the taps that feed
each such element and whose raw sum takes another ReLU slope in the kernel
than in the plain version, also written to ``refign_tpu_torch/build/ab/
k3_bwd_kink.json``), the timing goes on, and the exit code is 1.  K3's fused
mode with bf16 output (what the UAWarpC head launches) is checked and
timed in the same loop, for this checkout alone.  Older sources are
called by their own signatures, known by a marker: K1's forward without
the grad-mode statistics; K1's backward without them (it recomputes the
softmax); K2's forward without the weight strides (given the tap-major
(9, C) copy of the weights that their wrapper made); K2's backward with
its fp32 g' map; K3 without its two mode arguments.  K3's backward has
kept its C signature since it was added; a checkout without it times the
other kernels only.  This checkout's K1
backward reads the statistics of this checkout's grad-mode forward, made
once per shape outside the timing.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("sra_attention", "dwconv3x3_gelu", "local_correlation",
           "sra_attention_backward", "dwconv3x3_gelu_backward",
           "local_correlation_backward")
# a marker of each source's newer C signature: K1's grad-mode statistics
# (forward and backward), K2's weight strides, K2 backward's scratch query,
# K3's fused mode
MARKERS = {"sra_attention": "void* o32", "dwconv3x3_gelu": "w_si",
           "local_correlation": "out_bf16",
           "sra_attention_backward": "const void* o32",
           "dwconv3x3_gelu_backward": "dwconv3x3_gelu_backward_scratch"}


def build(root, tag):
    from refign_tpu_torch.ops import _build
    out_dir = os.path.join(HERE, "refign_tpu_torch", "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k in KERNELS:
        src = os.path.join(root, "refign_tpu_torch", "csrc", f"{k}.cu")
        if not os.path.exists(src):  # a kernel this checkout does not have
            continue
        out = os.path.join(out_dir, f"{tag}_{k}.so")
        procs[k] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out,
            src)
    libs = {}
    for k, (p, out, src) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        with open(src) as f:
            newer = MARKERS.get(k, "") in f.read()
        libs[k] = (ctypes.CDLL(out), newer)
    return libs


def k1_call(lib, newer, q, k, v, o, scale, stream):
    """K1's inference launch (no statistics)."""
    fn = lib.sra_attention_forward
    stats = [ctypes.c_void_p] * 2 if newer else []
    fn.argtypes = ([ctypes.c_void_p] * 4 + stats + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    B, N, H, _ = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *((None, None) if newer else ()), 1, B, N,
            k.shape[1], H, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], scale, stream)
    return lambda: fn(*args)


def k1_backward_call(lib, newer, q, k, v, g, stats, outs, scale, stream):
    """K1's bf16 backward into outs (dq, dk, dv); newer sources read the
    forward's statistics (o32, lse)."""
    import torch
    from refign_tpu_torch.ops.attention import dkdv_splits
    fn = lib.sra_attention_backward
    extra = [ctypes.c_void_p] * 2 if newer else []
    fn.argtypes = ([ctypes.c_void_p] * 4 + extra + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 21
                   + [ctypes.c_float, ctypes.c_void_p])
    B, N, H, _ = q.shape
    M = k.shape[1]
    nsplit = dkdv_splits(B, N, M, H, q.device)  # this checkout's, for both
    f32 = dict(dtype=torch.float32, device="cuda")
    scratch = torch.empty((1 if newer else 3) * B * H * N, **f32)
    part = torch.empty(2 * nsplit * B * H * M * 64, **f32)
    dq, dk, dv = outs
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            *((stats[0].data_ptr(), stats[1].data_ptr()) if newer else ()),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            part.data_ptr(), 1, B, N, M, H, nsplit, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], scale,
            stream)
    return lambda keep=(scratch, part): fn(*args)


def k2_backward_call(lib, newer, x, w, b, g, outs, stream):
    """K2's bf16 backward into outs (dx, dw, db), w OIHW; older sources
    take an fp32 g' map."""
    import torch
    B, H, W, C = x.shape
    dx, dw, db = outs
    f32 = dict(dtype=torch.float32, device="cuda")
    if newer:
        q = lib.dwconv3x3_gelu_backward_scratch
        q.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        q.restype = None
        sizes = (ctypes.c_longlong * 2)()
        q(x.data_ptr(), g.data_ptr(), dx.data_ptr(), 1, B, H, W, C, sizes)
        gp_n, part_n = sizes[0], sizes[1]
    else:
        q = lib.dwconv3x3_gelu_backward_partials
        q.argtypes = [ctypes.c_int] * 4
        q.restype = ctypes.c_longlong
        gp_n, part_n = x.numel(), q(B, H, W, C)
    gp = torch.empty(max(gp_n, 1), **f32)
    part = torch.empty(part_n, **f32)
    fn = lib.dwconv3x3_gelu_backward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    sc, _, si, sj = w.stride()
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            gp.data_ptr() if gp_n else None, part.data_ptr(), 1, B, H, W, C,
            si, sj, sc, si, sj, sc, stream)
    return lambda keep=(gp, part): fn(*args)


def k2_call(lib, strided, x, w, b, y, stream):
    fn = lib.dwconv3x3_gelu_forward
    B, H, W, C = x.shape
    if strided:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        sc, _, si, sj = w.stride()
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 1, B, H,
                W, C, si, sj, sc, stream)
    else:
        w9 = w.reshape(C, 9).t().contiguous()
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        args = (x.data_ptr(), w9.data_ptr(), b.data_ptr(), y.data_ptr(), 1, B, H,
                W, C, stream)
        return lambda keep=w9: fn(*args)  # the copy lives with the closure
    return lambda: fn(*args)


def k3_call(lib, newer, t, s, o, P, stream, fused=0):
    """K3 on bf16 inputs: the raw fp32 volume, or with ``fused`` (newer
    sources only) its relu_l2norm in bf16."""
    fn = lib.local_correlation_forward
    B, H, W, C = t.shape
    mode = [ctypes.c_int] * 2 if newer else []
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 8 + mode + [ctypes.c_void_p])
    args = (t.data_ptr(), s.data_ptr(), o.data_ptr(), 1, B, H, W, C, P,
            *t.stride(), *s.stride(), *((fused, fused) if newer else ()),
            stream)
    return lambda: fn(*args)


def k3_backward_call(lib, t, s, g, outs, P, stream):
    """K3's backward, fused mode, bf16 t, s and g, into outs (gt, gs) or
    (gs,) alone; the fp32 graw scratch is made once with the call."""
    import torch
    fn = lib.local_correlation_backward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
    B, H, W, C = t.shape
    graw = torch.empty((B, H, W, P * P), dtype=torch.float32, device="cuda")
    gt, gs = outs if len(outs) == 2 else (None, outs[0])
    args = (t.data_ptr(), s.data_ptr(), g.data_ptr(), graw.data_ptr(),
            None if gt is None else gt.data_ptr(), gs.data_ptr(), 1, 1, B, H,
            W, C, P, *t.stride(), *s.stride(), *g.stride(), 1, stream)
    return lambda keep=graw: fn(*args)


def k3_kink_report(lib, grad, got, ref, lim, t, s, P, stream, most=8):
    """K3-bwd's elements of gradient ``grad`` (0: gt, 1: gs) beyond the
    limit, at most ``most`` of them: each one's value, reference and limit,
    and every tap that feeds it whose raw sum takes another ReLU slope in
    the kernel (the forward's raw sums, which the backward's graw kernel
    forms bit for bit) than in the plain version, with its exact sum (fp64:
    the bf16 products and their sum are exact there).  Also written, with
    the tap's two vectors, to refign_tpu_torch/build/ab/k3_bwd_kink.json."""
    import json
    import torch
    from refign_tpu_torch.ops.correlation import local_correlation_reference
    B, H, W, C = t.shape
    R, PP = (P - 1) // 2, P * P
    plain = local_correlation_reference(t.float(), s.float(), P)
    kern = torch.empty_like(plain)
    if k3_call(lib, True, t, s, kern, P, stream)() != 0:
        raise RuntimeError("K3 launch failed")
    torch.cuda.synchronize()

    def slope(v):
        return 1.0 if v > 0 else 0.5 if v == 0 else 0.0

    bad = ((got.float() - ref).abs() > lim).nonzero().tolist()
    found = []
    for b, y, x, c in bad[:most]:
        taps = []
        for k in range(PP):
            dy, dx = divmod(k, P)
            # gt: pixel (y, x)'s own taps; gs: the taps of the target
            # pixels that see source pixel (y, x)
            py, px = (y, x) if grad == 0 else (y - dy + R, x - dx + R)
            sy, sx = py + dy - R, px + dx - R
            if not (0 <= py < H and 0 <= px < W and 0 <= sy < H
                    and 0 <= sx < W):
                continue
            pl, kn = plain[b, py, px, k].item(), kern[b, py, px, k].item()
            if slope(pl) == slope(kn):
                continue
            tv, sv = t[b, py, px].double(), s[b, sy, sx].double()
            taps.append(dict(
                target=[b, py, px], source=[b, sy, sx], tap=k, plain=pl,
                kernel=kn, exact=(tv * sv).sum().item(),
                magnitude=(tv * sv).abs().sum().item(),
                t=tv.tolist(), s=sv.tolist()))
        found.append(dict(grad="gt" if grad == 0 else "gs",
                          element=[b, y, x, c], got=got[b, y, x, c].item(),
                          ref=ref[b, y, x, c].item(),
                          limit=lim[b, y, x, c].item(), taps=taps))
        print(f"  {found[-1]['grad']}{[b, y, x, c]}: got "
              f"{found[-1]['got']!r}, ref {found[-1]['ref']!r}, limit "
              f"{found[-1]['limit']!r}; taps of another slope: " + (
                  "; ".join(f"target {d['target']} tap {d['tap']}: plain "
                            f"{d['plain']!r}, kernel {d['kernel']!r}, exact "
                            f"{d['exact']!r} (sum of magnitudes "
                            f"{d['magnitude']!r})" for d in taps)
                  or "none"), flush=True)
    out = os.path.join(HERE, "refign_tpu_torch", "build", "ab")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "k3_bwd_kink.json")
    old = []
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    with open(path, "w") as f:
        json.dump(old + [dict(shape=[B, H, W, C], P=P, elements=len(bad),
                              found=found)], f)


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from refign_tpu_torch.ops.attention import (sra_attention_forward,
                                                sra_attention_reference)
    from refign_tpu_torch.ops.correlation import (
        local_correlation_reference, local_correlation_relu_l2norm_reference)
    from refign_tpu_torch.ops.dwconv import dwconv3x3_gelu_reference

    libs = {"this": build(HERE, "this"),
            "other": build(os.path.abspath(sys.argv[1]), "other")}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 64 ** -0.5
    # per kernel: (launches per unit, label, references, (rel, abs) limit
    # of each, outputs, make(tag, outputs) -> a call, or None)
    cases = {"K1": [], "K2": [], "K3": [], "K3 fused": [], "K1-bwd": [],
             "K2-bwd": [], "K3-bwd": [], "K3-bwd path": []}
    # (name, label) -> what prints the elements of output j beyond the
    # limit: explain(j, got, ref, limit)
    explain = {}
    # (name, label) -> per output, K3-bwd's limit without its bf16
    # allowance on jump, and jump
    kinks = {}
    bf16_limit = [(chip_smoke.BF16_REL, chip_smoke.BF16_ABS)]
    for n, N, M, H, S, C in chip_smoke.STAGES:
        q, k, v = chip_smoke.attention_case(gen, chip_smoke.B_ROWS, N, M, H,
                                            torch.bfloat16)
        ref = sra_attention_reference(q.float(), k.float(), v.float(), scale)
        cases["K1"].append((n, f"B*H={chip_smoke.B_ROWS * H} N={N} M={M}",
                            [ref], bf16_limit, [torch.empty_like(q)],
                            lambda t, o, q=q, k=k, v=v: k1_call(
                                *libs[t]["sra_attention"], q, k, v, o[0],
                                scale, stream)))
        x, w, b = chip_smoke.dwconv_case(gen, chip_smoke.B_ROWS, S, C,
                                         torch.bfloat16)
        ref = dwconv3x3_gelu_reference(x.float(), w.float(), b.float())
        cases["K2"].append((n, f"({chip_smoke.B_ROWS},{S},{S},{C})", [ref],
                            bf16_limit, [torch.empty_like(x)],
                            lambda t, y, x=x, w=w, b=b: k2_call(
                                *libs[t]["dwconv3x3_gelu"], x, w, b, y[0],
                                stream)))
    P = chip_smoke.CORR_PATCH
    for B, H, W, C in chip_smoke.CORR_LEVELS:
        t, s = chip_smoke.corr_case(gen, B, H, W, C, torch.bfloat16)
        ref = local_correlation_reference(t, s, P)
        cases["K3"].append((1, f"({B},{H},{W},{C}) P={P}", [ref],
                            [(0.0, chip_smoke.CORR_ABS)],
                            [torch.empty_like(ref)],
                            lambda tag, o, t=t, s=s: k3_call(
                                *libs[tag]["local_correlation"], t, s, o[0],
                                P, stream)))
        ref = local_correlation_relu_l2norm_reference(t, s, P)
        cases["K3 fused"].append((
            1, f"({B},{H},{W},{C}) P={P} bf16 out", [ref],
            [(chip_smoke.BF16_REL, chip_smoke.CORR_ABS)],
            [torch.empty(ref.shape, dtype=torch.bfloat16, device="cuda")],
            lambda tag, o, t=t, s=s: k3_call(
                libs[tag]["local_correlation"][0], True, t, s, o[0], P,
                stream, fused=1) if tag == "this" else None))

    def grad_limits(refs):
        return [(chip_smoke.BF16_REL,
                 chip_smoke.GRAD_REL * r.abs().max().item()) for r in refs]

    def fp32_grads(fn, inputs, g):
        ref_in = [t.detach().float().requires_grad_() for t in inputs]
        return list(torch.autograd.grad(fn(*ref_in), ref_in, g.float()))

    for n, N, M, H, S, C in chip_smoke.TRAIN_STAGES:
        n *= chip_smoke.TRAIN_PASSES
        rows = chip_smoke.TRAIN_ROWS
        q, k, v = chip_smoke.attention_case(gen, rows, N, M, H,
                                            torch.bfloat16)
        g = torch.randn(rows, N, H, 64, generator=gen, device="cuda").bfloat16()
        refs = fp32_grads(
            lambda a, b_, c: sra_attention_reference(a, b_, c, scale),
            (q, k, v), g)
        stats = sra_attention_forward(q, k, v, scale, stats=True)[1]
        cases["K1-bwd"].append((
            n, f"B*H={rows * H} N={N} M={M}", refs, grad_limits(refs),
            [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)],
            lambda t, o, q=q, k=k, v=v, g=g, stats=stats: k1_backward_call(
                *libs[t]["sra_attention_backward"], q, k, v, g, stats, o,
                scale, stream)))
        x, w, b = chip_smoke.dwconv_case(gen, rows, S, C, torch.bfloat16)
        g = torch.randn(rows, S, S, C, generator=gen, device="cuda").bfloat16()
        refs = fp32_grads(dwconv3x3_gelu_reference, (x, w, b), g)
        cases["K2-bwd"].append((
            n, f"({rows},{S},{S},{C})", refs, grad_limits(refs),
            [torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)],
            lambda t, o, x=x, w=w, b=b, g=g: k2_backward_call(
                *libs[t]["dwconv3x3_gelu_backward"], x, w, b, g, o, stream)))

    for B, H, W, C in chip_smoke.ALIGN_TRAIN_LEVELS:
        t, s, g = chip_smoke.corr_grad_case(gen, B, H, W, C, P,
                                            torch.bfloat16, True)
        refs = fp32_grads(
            lambda a, b_: local_correlation_relu_l2norm_reference(a, b_, P),
            (t, s), g)
        scales, jumps = chip_smoke.corr_grad_scale(t, s, g, P, True)
        # chip_smoke.check_corr_grad's limit as (rel, abs), and the limit
        # without its bf16 allowance on jump, for the count of elements
        # that pass only by that allowance
        both = [chip_smoke.corr_grad_limit(r, sc, jp, torch.bfloat16)
                for r, sc, jp in zip(refs, scales, jumps)]
        limits = [(0.0, lim) for lim, _ in both]
        for name, keep in (("K3-bwd", (0, 1)), ("K3-bwd path", (1,))):
            kinks[(name, f"({B},{H},{W},{C}) P={P}")] = [
                (both[i][1], jumps[i]) for i in keep]
            explain[(name, f"({B},{H},{W},{C}) P={P}")] = (
                lambda j, got, ref, lim, keep=keep, t=t, s=s: k3_kink_report(
                    libs["this"]["local_correlation"][0], keep[j], got, ref,
                    lim, t, s, P, stream))
            cases[name].append((
                chip_smoke.ALIGN_TRAIN_PASSES, f"({B},{H},{W},{C}) P={P}",
                [refs[i] for i in keep], [limits[i] for i in keep],
                [torch.empty_like(t) for _ in keep],
                lambda tag, o, t=t, s=s, g=g: k3_backward_call(
                    libs[tag]["local_correlation_backward"][0], t, s, g, o, P,
                    stream) if "local_correlation_backward" in libs[tag]
                else None))

    def unit(name):
        return ("UAWarpC step" if name.startswith("K3-bwd") else "align"
                if name.startswith("K3") else "train step"
                if name.endswith("bwd") else "forward")

    best = {}
    failures = []
    for rnd, tag in enumerate(("other", "this", "this", "other")):
        for name, rows in cases.items():
            times = []
            for n, label, refs, limits, outs, make in rows:
                fn = make(tag, outs)
                if fn is None:  # a mode this checkout alone has
                    continue
                if fn() != 0:
                    raise RuntimeError(f"{name} ({tag}) launch failed")
                torch.cuda.synchronize()
                for j, (ref, (rel, abs_), out) in enumerate(
                        zip(refs, limits, outs)):
                    lim = rel * ref.abs() + abs_
                    err = (out.float() - ref).abs()
                    bad = int((err > lim).sum())
                    what = f"{name} {label} ({tag}) output {j}"
                    if (name, label) in kinks and rnd < 2:
                        old, jump = kinks[(name, label)][j]
                        print(f"{what}: "
                              f"{chip_smoke.kink_only(err, lim, old, jump, what)}"
                              f" elements within the limit only by the bf16 "
                              f"allowance on jump", flush=True)
                    if bad and not any(f.startswith(what) for f in failures):
                        # a failure is reported once, and the run goes on
                        # to time every kernel; the exit code is 1
                        failures.append(f"{what}: {bad} elements beyond the "
                                        f"limit; max abs err "
                                        f"{err.max().item():.3e}")
                        print("FAILED " + failures[-1], flush=True)
                        if tag == "this" and (name, label) in explain:
                            explain[(name, label)](j, out, ref, lim)
                t = chip_smoke.time_ms(fn)
                times.append(t)
                key = (name, label, tag)
                best[key] = min(best.get(key, t), t)
            if not times:
                continue
            per_unit = sum(r[0] * t for r, t in zip(rows, times))
            print(f"run {rnd} {tag:5s} {name}: "
                  f"{[round(t, 4) for t in times]} ms per launch, "
                  f"{per_unit:.3f} ms per {unit(name)}", flush=True)
    for name, rows in cases.items():
        tags = [tag for tag in ("other", "this")
                if (name, rows[0][1], tag) in best]
        for n, label, *_ in rows:
            ms = [best[(name, label, tag)] for tag in tags]
            ratio = f" ({ms[0] / ms[1]:.2f}x)" if len(ms) == 2 else ""
            print(f"{name} {label} x{n}: " + ", ".join(
                f"{tag} {t:.4f} ms" for tag, t in zip(tags, ms)) + ratio)
        for tag in tags:
            tot = sum(r[0] * best[(name, r[1], tag)] for r in rows)
            print(f"{name} best per {unit(name)}, {tag}: {tot:.3f} ms")
    print(chip_smoke.card_line())
    for f in failures:
        print("FAILED " + f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
