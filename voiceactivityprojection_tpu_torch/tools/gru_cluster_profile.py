"""Where a step of the GRU cluster kernel goes, on the card.

    python3 -m voiceactivityprojection_tpu_torch.tools.gru_cluster_profile

1. Per-phase cycles: builds a copy of ``csrc/gru_cluster.cuh`` with
   ``clock64()`` counters between the phases of a step (into
   ``build/profile/``; the package's own libraries stay untouched), runs
   K3 and K2 at 2000 steps and prints, per case, the microseconds a step
   (CUDA events) and the cycles a step each phase took in thread 0 of the
   first CTA of each K half.
2. A tiling sweep: the package's cluster entry points at every tiling they
   are built for, at R = 2, 8, 32, 128 x 2000 steps, beside the bf16 block
   kernel, in microseconds a step.

Prints one JSON line per case. Needs an NVIDIA H100 and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from voiceactivityprojection_tpu_torch.ops import _build, gru_cluster
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3

H = 256
STEPS = 2000
PROFILE_DIR = _build.BUILD_DIR / "profile"
# (counter slot, the source line it is placed before or after, where)
PHASES = (
    (0, "    const uint32_t next_bar = mbar + 8 * (cur ^ 1);\n", "after"),
    (1, "    float g0[N], g1[N], c0[N], c1[N];", "before"),
    (2, "    wg::commit();\n", "after"),
    (3, "    // the GRU's products (the conv's may still run)", "before"),
    (4, "    if constexpr (DS) {\n      wg::wait<0>();  // the conv's products", "before"),
    (7, "    fence_proxy_async_cta();  // the new h, before", "before"),
    (5, "    // this CTA's slice of the new h to every peer", "before"),
)
NAMES = ("top of the step", "wait for the peers' slices", "issue the GRU products",
         "issue the conv, expect bytes, prefetch x, K2 statistics", "GRU wait, K-half exchange, gates",
         "fence, x wait, CTA barrier", "broadcast, K2 row sums", "conv wait, exchange, adds")


def instrumented_source() -> str:
    s = (_build.CSRC_DIR / "gru_cluster.cuh").read_text()
    s = s.replace("namespace vap {\nnamespace gc {", "__device__ long long g_prof[16];\nnamespace vap {\nnamespace gc {", 1)
    loop = "  for (int t = 0; t < steps; ++t) {\n    const int cur = t & 1;"
    s = s.replace(loop, "  long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long last_ = clock64();\n"
                  "#define P(k) { long long now_ = clock64(); acc_[k] += now_ - last_; last_ = now_; }\n" + loop, 1)
    for slot, line, where in PHASES:
        if line not in s:
            raise RuntimeError(f"profile: the kernel has no line {line!r}")
        s = s.replace(line, line + f"    P({slot})\n" if where == "after" else f"    P({slot})\n" + line, 1)
    end = "      __syncwarp();  // this warp's own partials before its reads next step\n    }\n"
    s = s.replace(end, end + "    P(6)\n", 1)
    s = s.replace("  cluster_arrive();  // no CTA leaves",
                  "  if (blockIdx.x == 0 && (threadIdx.x & 127) == 0)\n"
                  "    for (int i = 0; i < 8; ++i) g_prof[8 * (threadIdx.x >> 7) + i] = acc_[i];\n"
                  "  cluster_arrive();  // no CTA leaves", 1)
    return s


def build_instrumented() -> dict:
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(f, PROFILE_DIR / f.name)
    (PROFILE_DIR / "gru_cluster.cuh").write_text(instrumented_source())
    read = '\nextern "C" int read_prof(long long* out) {\n  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 16));\n}\n'
    procs = {}
    for name in ("gru_recurrence", "gru_downsample"):
        src = PROFILE_DIR / f"{name}.cu"
        src.write_text((_build.CSRC_DIR / f"{name}.cu").read_text() + read)
        out = PROFILE_DIR / f"lib{name}_profile.so"
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"profile build of {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def inputs(R, T, gen):
    bf = dict(device="cuda", dtype=torch.bfloat16)
    w_hh = (torch.randn(H, 3 * H, generator=gen) / 16).to(**bf)
    b_hh = (0.1 * torch.randn(3 * H, generator=gen)).to(**bf)
    xp = (0.5 * torch.randn(R, T, 3 * H, generator=gen)).to(**bf)
    h0 = (0.1 * torch.randn(R, H, generator=gen)).to(**bf)
    ds = [(torch.randn(5, H, H, generator=gen) / 36).to(**bf), (0.1 * torch.randn(H, generator=gen)).to(**bf),
          (1 + 0.1 * torch.randn(H, generator=gen)).to(**bf), (0.1 * torch.randn(H, generator=gen)).to(**bf)]
    return xp, w_hh, b_hh, h0, ds


def launcher(lib, fused, R, T, rows, args):
    xp, w_hh, b_hh, h0, ds = args
    out = torch.empty(R, (T + 1) // 2 if fused else T, H, device="cuda", dtype=torch.bfloat16)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = lambda: ctypes.c_void_p(_build.stream_handle(out))
    if fused:
        return lambda: lib.vap_gru_downsample_cluster(p(xp), p(w_hh), p(b_hh), p(h0), *map(p, ds), p(out),
                                                      R, T, 8, rows, stream())
    return lambda: lib.vap_gru_recurrence_cluster(p(xp), p(w_hh), p(b_hh), p(h0), p(out), R, T, 8, rows, stream())


def us_per_step(fn, T, reps=3) -> float:
    if fn() != 0:
        raise RuntimeError("launch refused")
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps * 1e3 / T


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gru_cluster_profile needs an NVIDIA GPU")
    gen = torch.Generator().manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = build_instrumented()
    for fused, R, rows in ((False, 2, 8), (False, 16, 16), (True, 16, 16), (True, 8, 8)):
        lib = libs["gru_downsample" if fused else "gru_recurrence"]
        fn = launcher(lib, fused, R, STEPS, rows, inputs(R, STEPS, gen))
        us = us_per_step(fn, STEPS, reps=1)
        prof = (ctypes.c_longlong * 16)()
        if lib.read_prof(prof) != 0:
            raise RuntimeError("read_prof failed")
        halves = [{NAMES[i]: prof[8 * h + i] / STEPS for i in range(8)} for h in range(2)]
        print(json.dumps({"case": "K2" if fused else "K3", "rows": R, "rows_a_cluster": rows, "steps": STEPS,
                          "us_per_step_instrumented": us, "cycles_per_step": halves, "card": card}), flush=True)
    sweep = []
    for R in (2, 8, 32, 128):
        args = inputs(R, STEPS, gen)
        line = {"rows": R}
        for fused, tilings, lib in ((False, gru_cluster.RECURRENCE_TILINGS, k3._lib()),
                                    (True, gru_cluster.DOWNSAMPLE_TILINGS, k2._lib())):
            for c, n in tilings:
                line[f"{'K2' if fused else 'K3'} {n} rows"] = us_per_step(launcher(lib, fused, R, STEPS, n, args), STEPS)
        xp, w_hh, b_hh, h0, _ = args
        ys = torch.empty(R, STEPS, H, device="cuda", dtype=torch.bfloat16)
        block = lambda: k3._lib().vap_gru_recurrence(xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
                                                     ys.data_ptr(), R, STEPS, H, 1, _build.stream_handle(ys))
        line["K3 bf16 block kernel"] = us_per_step(block, STEPS)
        sweep.append(line)
    print(json.dumps({"sweep_us_per_step": sweep, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
