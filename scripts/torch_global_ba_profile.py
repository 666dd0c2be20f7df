"""Where an LM attempt of global BA spends its time on the card.

    python3 scripts/torch_global_ba_profile.py [--M 131072] [--device cpu]

Builds SCALING.md's problem (64 keyframes, M landmarks, 8 observations
each; M=131072 is 1,048,576 observation slots) in float32, then:

1. times ``global_ba.assemble`` and ``global_ba.reduce_camera_system``
   with CUDA events over 10 back-to-back calls each, after two warm-ups;
2. traces 3 assemblies with ``torch.profiler`` (CPU and CUDA) and prints
   the device kernels by total device time, the share of the scatters
   (``index_add_``), the kernel count per assembly, and the device's busy
   share of the traced wall time.

``--device cpu`` rehearses the script at a small M; its times are the
CPU's and say nothing of the card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=131072)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    from vio_tpu_torch import testing
    from vio_tpu_torch.device import resolve
    from vio_tpu_torch.parallel import global_ba

    device, _ = resolve(args.device, torch.float32)
    cuda = device.type == "cuda"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        tag = f"[{smi.strip().splitlines()[0]}]"
    else:
        tag = "[CPU rehearsal, no device numbers]"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gt, _ = testing.make_global_problem(N=64, M=args.M, obs_per_lm=8, device=device,
                                        dtype=torch.float32)
    p = testing.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)
    N, M = 64, args.M
    O = int(p.valid.sum())
    asm = lambda: global_ba.assemble(p, N, M, 2, 1.0)  # noqa: E731
    n = asm()
    red = lambda: global_ba.reduce_camera_system(n, p.lm_valid)  # noqa: E731
    for fn in (asm, asm, red, red):
        fn()
    sync()

    def ms(fn, reps=10):
        if not cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    print(f"{O} observations, P={6 * N}, float32 {tag}")
    print(f"assemble {ms(asm):.3f} ms, reduce_camera_system {ms(red):.3f} ms "
          f"(back-to-back, {'CUDA events' if cuda else 'host clock'}) {tag}")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    reps = 3
    sync()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            asm()
        sync()
    wall = 1e3 * (time.perf_counter() - t0)
    if not cuda:
        print(f"traced wall {wall:.1f} ms over {reps} assemblies {tag}")
        return
    rows = [r for r in prof.key_averages()
             if r.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in rows) / 1e3
    if not rows or busy == 0.0:
        print(f"the profiler saw no device time; the CUDA-event times above stand {tag}")
        return
    launches = sum(r.count for r in rows)
    scatter = sum(r.self_device_time_total for r in rows if "index" in r.key.lower()) / 1e3
    print(f"traced {reps} assemblies: wall {wall:.3f} ms, device kernels {launches // reps} "
          f"per assembly, device time {busy / reps:.3f} ms per assembly, busy "
          f"{100 * busy / wall:.1f} % of the traced wall, index_add_ scatters "
          f"{scatter / reps:.3f} ms per assembly ({100 * scatter / busy:.1f} % of device time) {tag}")
    for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:12]:
        print(f"  {r.self_device_time_total / 1e3 / reps:9.3f} ms/assembly "
              f"{r.count // reps:5d} launches  {r.key[:110]}")


if __name__ == "__main__":
    main()
