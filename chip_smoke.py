"""Drive tpureg_torch on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

1. the card (nvidia-smi name and power limit), versions and TF32 flags;
2. build the CUDA kernels from ``tpureg_torch/csrc`` and show ptxas's report;
3. K1 (correlation) against its plain version at FlowNetC's shape, fp32 and
   bf16, and at PWC's (4, 1);
4. K3 (bilinear warp) against its plain version at 256², B=8, fp32 and bf16;
5. the main path: a seeded, full-width FlowNet2 registration head runs the
   eval step at 256², batch 8, with segmentations, in fp32 and bf16; the
   launch counters must show 1 K1 and 7 K3 launches per step; batch 1 is
   held against the same weights on the CPU through the plain versions;
6. the inference CLI on phantom Analyze volumes, on the card;
7. timings with CUDA events: each kernel and its plain version, the
   ``grid_sample`` yardstick for K3, the eval step at batch 8, peak memory;
8. a torch.profiler breakdown of one eval step by kernel group.

The line before the last is the kernel table as JSON, the one before it the
card; the last line is ``{"ok": true, "device": {...}}``. Any failed phase
ends the run with a traceback and a non-zero exit, and prints no result.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpureg_torch.cli import inference as cli_inference
from tpureg_torch.ops import cuda_lib
from tpureg_torch.ops.correlation import (
    correlation_cuda,
    correlation_reference,
    displacement_count,
)
from tpureg_torch.ops.warp import sample2d_cuda, sample2d_gather
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import (
    make_eval_step,
    save_best_weights,
    set_fp32_numerics,
)

DEV = torch.device("cuda")
SIZE, BATCH = 256, 8
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,     # fp32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores, dense
COUNTERS = (correlation_cuda, sample2d_cuda)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(title):
    print(f"\n=== {title}", flush=True)


def reset_counts():
    for fn in COUNTERS:
        fn.launches = 0


def counts():
    return {"correlation": correlation_cuda.launches,
            "warp2d": sample2d_cuda.launches}


# ---------------------------------------------------------------------------
# timing

def time_ms(fn, reps, head_start_ms=20.0):
    """Mean device time of ``fn`` over ``reps`` back-to-back launches between
    two CUDA events, after a warm-up. The card first spins for
    ``head_start_ms`` so that the host queues every launch before the start
    event runs: a short kernel is then timed on the card, not by the host's
    launch overhead. The inputs stay in the 50 MB L2, as they are in the eval
    step, where each input's producer runs just before."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(head_start_ms * 2e6))  # ~2e6 cycles a ms at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    starved = start.query()  # the card reached the start before the host was done
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    if starved:
        print(f"  (timer: the host queued {reps} calls slower than the card ran "
              f"them; {ms * 1e3:.2f} us a call includes launch gaps)")
    return ms


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def correlation_work(shape, md, s2, dtype):
    """(bytes, flops) that the correlation needs on these inputs: each input
    read once, the output written once, one multiply-add per in-image tap."""
    b, c, h, w = shape
    k = displacement_count(md, s2)
    es = torch.finfo(dtype).bits // 8
    taps_y = sum(max(0, min(h, h - (iy * s2 - md)) - max(0, -(iy * s2 - md)))
                 for iy in range(k))
    taps_x = sum(max(0, min(w, w - (ix * s2 - md)) - max(0, -(ix * s2 - md)))
                 for ix in range(k))
    nbytes = 2 * b * c * h * w * es + b * k * k * h * w * es
    return nbytes, 2 * b * c * taps_y * taps_x


def warp_work(img, p):
    """(bytes, flops) of one bilinear sample of ``img`` at p positions per
    image: image, positions and fp32 output once each; 8 FLOP of weights per
    position and 7 per channel."""
    b, c, h, w = img.shape
    nbytes = img.numel() * img.element_size() + 2 * b * p * 4 + b * c * p * 4
    return nbytes, b * p * (8 + 7 * c)


# ---------------------------------------------------------------------------
# data

def phantom_batch(b, size, seed):
    """Fixed/moving 'slices': nested ellipses with 4 labels, intensity
    label/3 plus noise, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    segs = np.empty((b, size, size, 2), np.float32)
    for i in range(b):
        for ch in range(2):
            cx, cy = rng.uniform(0.4, 0.6, 2)
            rx, ry = rng.uniform(0.25, 0.35, 2)
            r = np.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
            segs[i, ..., ch] = np.select([r < 0.4, r < 0.7, r < 1.0], [3, 2, 1], 0)
    imgs = segs / 3 + rng.normal(0, 0.02, segs.shape)
    return (torch.from_numpy(np.clip(imgs, 0, 1).astype(np.float32)),
            torch.from_numpy(segs))


def write_analyze(path_base, vol):
    """A little-endian int16 Analyze 7.5 pair (.hdr/.img)."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = (len(vol.shape),) + vol.shape + (1,) * (7 - len(vol.shape))
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 4)
    struct.pack_into("<h", hdr, 72, 16)
    struct.pack_into("<8f", hdr, 76, 0, 1, 1, 1, 1, 0, 0, 0)
    with open(path_base + ".hdr", "wb") as f:
        f.write(hdr)
    vol.astype(np.int16).ravel(order="F").tofile(path_base + ".img")


def phantom_volume(rng, shape=(176, 208, 176)):
    """An OASIS-sized ellipsoid 'head' with 3 nested tissue labels, long in
    z so that every slice of the pipeline's crop holds all three."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n, dtype=np.float32)
                            for n in shape), indexing="ij")
    c = rng.uniform(-0.1, 0.1, 2).astype(np.float32)
    r = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z / 2.5) ** 2)
    seg = np.select([r < 0.35, r < 0.6, r < 0.85], [3, 2, 1], 0)
    img = seg * 250 + rng.normal(0, 15, shape)
    return img, seg


# ---------------------------------------------------------------------------
# phases

def card():
    phase("1. card and settings")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    set_fp32_numerics()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    return smi


def build():
    phase("2. build")
    t0 = time.time()
    path = cuda_lib.build()
    cuda_lib.load()
    print(f"built {path.name} in {time.time() - t0:.1f} s")
    print(cuda_lib.ptxas_report())


def check_correlation():
    phase("3. K1 correlation against its plain version")
    errs = {}
    g = torch.Generator(device=DEV).manual_seed(0)
    for shape, md, s2 in (((BATCH, 256, 32, 32), 20, 2), ((BATCH, 64, 32, 32), 4, 1)):
        f1 = torch.randn(shape, device=DEV, generator=g)
        f2 = torch.randn(shape, device=DEV, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            a, b = f1.to(dtype), f2.to(dtype)
            got = correlation_cuda(a, b, md, s2).float()
            want = correlation_reference(a, b, md, s2).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if dtype == torch.float32:
                # fp32 sums of C products in another order
                tol = "1e-5 abs"
                ok = err <= 1e-5
            else:
                # both round the same fp32 sum to bf16: one bf16 step apart
                tol = "2^-7 rel + 1e-6"
                ok = bool(((got - want).abs()
                           <= 2.0**-7 * want.abs() + 1e-6).all())
            print(f"  {tuple(shape)} md {md} s2 {s2} {str(dtype)[6:]}: "
                  f"max |kernel - plain| = {err:.3g} (tolerance {tol})")
            require(ok, f"K1 disagrees with its plain version ({dtype}, md {md})")
            if (md, s2) == (20, 2):
                errs[dtype] = err
    return errs


def warp_inputs(dtype, seed=1):
    g = torch.Generator(device=DEV).manual_seed(seed)
    img = torch.rand((BATCH, 1, SIZE, SIZE), device=DEV, generator=g).to(dtype)
    flow = torch.randn((BATCH, 2, SIZE, SIZE), device=DEV, generator=g) * 60.0
    base = torch.arange(SIZE, device=DEV, dtype=torch.float32)
    px = (base + flow[:, 0]).reshape(BATCH, -1).contiguous()
    py = (base[:, None] + flow[:, 1]).reshape(BATCH, -1).contiguous()
    return img, px, py


def check_warp():
    phase("4. K3 bilinear warp against its plain version")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        img, px, py = warp_inputs(dtype)
        require(float(px.min()) < 0 and float(py.max()) > SIZE,
                "the warp check needs out-of-image taps")
        got = sample2d_cuda(img, px, py)
        want = sample2d_gather(img.float(), px, py).reshape(got.shape)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"  {(BATCH, 1, SIZE, SIZE)} P={SIZE * SIZE} {str(dtype)[6:]}: "
              f"max |kernel - plain| = {err:.3g} (tolerance 0: same roundings)")
        require(err == 0.0, f"K3 disagrees with its plain version ({dtype})")
        errs[dtype] = err
    return errs


def main_path(model):
    phase("5. main path: FlowNet2 eval step at 256², batch 8, with segs")
    imgs, segs = phantom_batch(BATCH, SIZE, seed=2)
    imgs, segs = imgs.to(DEV), segs.to(DEV)
    launches, steps, results = {}, {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        step = make_eval_step(model, compute_dtype=dtype)
        torch.cuda.synchronize()
        reset_counts()
        (flows, warped, wsegs, grid), metrics = step(imgs, segs)
        torch.cuda.synchronize()
        launches[name] = counts()
        print(f"  {name}: launches {launches[name]}; loss "
              f"{float(metrics['loss']):.6g}, photo {float(metrics['photo_loss']):.6g}, "
              f"corr {float(metrics['corr_loss']):.6g}, "
              f"smooth {float(metrics['smooth_loss']):.6g}")
        require(launches[name] == {"correlation": 1, "warp2d": 7},
                f"{name} step should launch K1 once and K3 7 times: {launches[name]}")
        require(flows[0].shape == (BATCH, SIZE, SIZE, 2) and len(flows) == 2,
                "flow shape")
        require(warped[0].shape == (BATCH, SIZE, SIZE, 1)
                and wsegs.shape == (BATCH, SIZE, SIZE, 1)
                and grid.shape == (BATCH, SIZE, SIZE, 1), "output shapes")
        for t in (*flows, *warped, wsegs, grid, *metrics.values()):
            require(bool(torch.isfinite(t.float()).all()), f"{name}: non-finite output")
        require(set(torch.unique(wsegs).tolist()) <= {0.0, 1.0, 2.0, 3.0},
                "warped labels outside 0..3")
        print(f"  {name}: |flow| max {float(flows[0].float().abs().max()):.4g} px, "
              f"warped image mean {float(warped[0].float().mean()):.4g}")
        steps[name] = step
        results[name] = (flows[0].float(), metrics)
    # fp32 and bf16 agree loosely (bf16 keeps 8 bits through ~60 layers)
    rel = abs(float(results["bf16"][1]["loss"]) / float(results["fp32"][1]["loss"]) - 1)
    print(f"  bf16 vs fp32 total loss: {rel:.3g} relative")

    # batch 1 against the same weights on the CPU, through the plain versions
    cpu_model = copy.deepcopy(model).cpu()
    (cflows, _, _, _), cmetrics = make_eval_step(cpu_model)(imgs[:1].cpu(),
                                                             segs[:1].cpu())
    (gflows, _, _, _), gmetrics = steps["fp32"](imgs[:1], segs[:1])
    scale = float(cflows[0].abs().max())
    ferr = float((gflows[0].cpu() - cflows[0]).abs().max())
    print(f"  batch 1, card vs CPU (fp32, no TF32): max |Δflow| = {ferr:.3g} "
          f"at |flow| ≤ {scale:.4g} (tolerance 1e-3 of the scale)")
    require(ferr <= 1e-3 * max(scale, 1.0), "card and CPU flows disagree")
    for k in cmetrics:
        r = abs(float(gmetrics[k]) / float(cmetrics[k]) - 1)
        print(f"    {k}: card {float(gmetrics[k]):.7g}, CPU {float(cmetrics[k]):.7g}, "
              f"{r:.3g} relative (tolerance 1e-4)")
        require(r <= 1e-4, f"card and CPU {k} disagree")
    return launches, steps, imgs, segs, results["fp32"][0]


def run_cli(model):
    phase("6. inference CLI on phantom volumes, on the card")
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for name in ("fiximg", "fixseg", "movimg", "movseg"):
            dirs[name] = os.path.join(tmp, name)
            os.mkdir(dirs[name])
        for kind, n in (("fix", 1), ("mov", 2)):
            for i in range(n):
                img, seg = phantom_volume(rng)
                write_analyze(os.path.join(dirs[f"{kind}img"], f"{kind}{i}_mpr"), img)
                write_analyze(os.path.join(dirs[f"{kind}seg"], f"{kind}{i}_seg"), seg)
        save_best_weights(tmp, "FlowNet2", model, {"loss": 0.0})
        reset_counts()
        results = cli_inference.main([
            "--mode", "real", "--model", "flownet2", "--batch_size", "1",
            "--fiximg_dir", dirs["fiximg"], "--fixseg_dir", dirs["fixseg"],
            "--movimg_dir", dirs["movimg"], "--movseg_dir", dirs["movseg"],
            "--workdir", tmp, "--logdir", os.path.join(tmp, "log"),
            "--max_samples", "4",
        ], device="cuda")
        torch.cuda.synchronize()
    got = counts()
    print(f"  CLI launches over 4 batches: {got}")
    require(got == {"correlation": 4, "warp2d": 28}, "CLI launch counts")
    for k, v in results.items():
        require(np.isfinite(v), f"CLI metric {k} is not finite")
    return results


def timings(steps, imgs, segs, flow, errs):
    phase("7. timings (CUDA events, back-to-back launches queued ahead, warm L2)")
    kernels = []
    g = torch.Generator(device=DEV).manual_seed(4)
    f1 = torch.randn((BATCH, 256, 32, 32), device=DEV, generator=g)
    f2 = torch.randn((BATCH, 256, 32, 32), device=DEV, generator=g)
    for dtype, name, line in ((torch.float32, "correlation", 54),
                              (torch.bfloat16, "correlation_bf16", 130)):
        a, b = f1.to(dtype), f2.to(dtype)
        ms = time_ms(lambda: correlation_cuda(a, b, 20, 2), 50)
        plain = time_ms(lambda: correlation_reference(a, b, 20, 2), 3,
                        head_start_ms=300.0)
        nbytes, flops = correlation_work(a.shape, 20, 2, dtype)
        bms, by = bound(nbytes, flops, dtype)
        kernels.append({"name": name, "route": "cuda",
                        "source": "tpureg_torch/csrc/correlation.cu",
                        "replaces": f"tpureg/ops/correlation_pallas.py:{line}",
                        "launches": None, "max_abs_err": errs["corr"][dtype],
                        "ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by, "library_ms": None})
    # K3 at the positions of the main path: the head's stn warp of the moving
    # image by the fp32 step's fused flow, (x + u) * (W - 1) / W
    base = torch.arange(SIZE, device=DEV, dtype=torch.float32)
    px = ((base + flow[..., 0]) * ((SIZE - 1) / SIZE)).reshape(BATCH, -1).contiguous()
    py = ((base[:, None] + flow[..., 1]) * ((SIZE - 1) / SIZE)).reshape(
        BATCH, -1).contiguous()
    moving = imgs[..., 1][:, None].contiguous()
    for dtype, name in ((torch.float32, "warp2d"), (torch.bfloat16, "warp2d_bf16")):
        img = moving.to(dtype)
        ms = time_ms(lambda: sample2d_cuda(img, px, py), 200)
        plain = time_ms(lambda: sample2d_gather(img, px, py), 20,
                        head_start_ms=100.0)
        # and at the scattered out-of-image positions of phase 4
        rimg, rpx, rpy = warp_inputs(dtype, seed=5)
        scattered = time_ms(lambda: sample2d_cuda(rimg, rpx, rpy), 200)
        print(f"  {name}: kernel at scattered positions (flow std 60 px): "
              f"{scattered * 1e3:.2f} us")
        library = None
        if dtype == torch.float32:
            # grid_sample on the same positions, normalised for
            # align_corners=True: x_norm = 2 x / (W - 1) - 1
            grid = torch.stack([px * (2 / (SIZE - 1)) - 1, py * (2 / (SIZE - 1)) - 1],
                               -1).reshape(BATCH, SIZE, SIZE, 2)
            ref = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=True).reshape(BATCH, 1, -1)
            yard_err = float((ref - sample2d_cuda(img, px, py)).abs().max())
            print(f"  grid_sample yardstick agrees with K3 to {yard_err:.3g}")
            library = time_ms(lambda: F.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), 200)
        nbytes, flops = warp_work(img, px.shape[1])
        bms, by = bound(nbytes, flops, torch.float32)
        kernels.append({"name": name, "route": "cuda",
                        "source": "tpureg_torch/csrc/warp2d.cu",
                        "replaces": "tpureg/ops/warp_pallas.py:183",
                        "launches": None, "max_abs_err": errs["warp"][dtype],
                        "ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by, "library_ms": library})
    for k in kernels:
        lib = "n/a" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.2f} us"
        print(f"  {k['name']:17s} kernel {k['ms'] * 1e3:8.2f} us  plain "
              f"{k['plain_ms'] * 1e3:9.2f} us  bound {k['bound_ms'] * 1e3:6.2f} us "
              f"({k['bound_by']})  library {lib}")

    for name, step in steps.items():
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step(imgs, segs)
            float(metrics["loss"])
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        print(f"  eval step {name}, batch {BATCH} at 256² with segs: median "
              f"{med:.3f} ms ({med / BATCH:.3f} ms per pair; min {min(times):.3f}, "
              f"max {max(times):.3f}, 10 steps)")
    torch.cuda.reset_peak_memory_stats()
    steps["fp32"](imgs, segs)
    torch.cuda.synchronize()
    print(f"  peak memory of the fp32 step: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (allocated)")
    return kernels


def _kernel_group(name):
    if "corr_fwd_kernel" in name:
        return "K1 correlation"
    if "warp2d_fwd_kernel" in name:
        return "K3 warp"
    low = name.lower()
    if any(t in low for t in ("conv", "cudnn", "xmma", "gemm", "dgrad", "wgrad",
                              "fprop", "fft", "dse::", "nchwtonhwc",
                              "nhwctonchw", "tensortransform", "cutlass")):
        return "cuDNN (convolutions, FFTs, layout transforms)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other (elementwise, resize, reductions)"


def breakdown(steps, imgs, segs):
    phase("8. where the eval step's time goes (torch.profiler, one step each)")
    from torch.profiler import ProfilerActivity, profile

    for name, step in steps.items():
        step(imgs, segs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            step(imgs, segs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        groups, per_kernel, launches = {}, {}, 0
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = evt.device_time_total / 1e3
            launches += 1
            groups[_kernel_group(evt.name)] = groups.get(_kernel_group(evt.name), 0) + ms
            per_kernel[evt.name] = per_kernel.get(evt.name, 0) + ms
        busy = sum(groups.values())
        if not launches:
            print(f"  {name}: the profiler recorded no device time (not measured)")
            continue
        print(f"  {name}: {launches} device kernels, busy {busy:.3f} ms of a "
              f"{wall:.3f} ms profiled step ({100 * (1 - busy / wall):.1f}% idle)")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {g:40s} {ms:8.3f} ms  {100 * ms / busy:5.1f}%")
        for k, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
            print(f"      {ms:8.3f} ms  {k[:100]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA card found")
    t_start = time.time()
    smi = card()
    build()
    errs = {"corr": check_correlation(), "warp": check_warp()}

    model = OpticalFlowReg("flownet2", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    model.to(DEV)
    print(f"\nFlowNet2 registration head: {n_params / 1e6:.2f} M parameters, "
          f"seeded random weights")
    launches, steps, imgs, segs, flow = main_path(model)
    run_cli(model)
    kernels = timings(steps, imgs, segs, flow, errs)
    breakdown(steps, imgs, segs)
    for k in kernels:
        k["launches"] = launches["bf16" if k["name"].endswith("_bf16") else "fp32"][
            "correlation" if k["name"].startswith("correlation") else "warp2d"]
    print(f"\nall phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
