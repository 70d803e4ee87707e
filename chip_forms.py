#!/usr/bin/env python3
"""The forms of the reverse-sweep kernel K5 that were tried beside the one
kept, and where a step of the kept form goes.

    python3 chip_forms.py

Makes variants of ``umx_tpu_torch/csrc/lstm_train.cu`` by text substitution
(the source itself carries no switches), builds each with its own nvcc into
``build/chip_forms/`` (all in parallel), checks that every variant gives the
kept form's bits, and times them in turns in one process at the UMX-L
training width (T = 256, R = 8 chains, G = 512) at 1, 3, 6 and 16 rows per
chain: microseconds per step, two rounds.  One variant carries cycle
counters (``clock64`` of one thread of one block): the phases of a step.
A measurement aid beside ``chip_smoke.py``, not a check.  Needs one CUDA
GPU and exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import chip_smoke as S

T, R, G = S.T_TRAIN, S.R_CHAINS, S.G_HIDDEN
ROWS = (1, 3, 6, 16)

WAIT = """      if (NT == 2 ? polls : (warp == 0 && lane < (int)gridDim.x)) {
        unsigned polled = 0;
        while ((int)(ld_acquire(flag_r + lane) - want) < 0) {
          if (++polled > BW_MAX_POLLS) __trap();
        }
      }
      if (NT == 2) {
        __syncwarp();
      } else {
        __syncthreads();
      }
"""
POLL_LOOP = """        while ((int)(ld_acquire(flag_r + lane) - want) < 0) {
          if (++polled > BW_MAX_POLLS) __trap();
        }
"""
COPY = """          for (int b = 0; b < nb; ++b) cp_async16(dst + b * SW, src + (size_t)b * G4);
"""
COPY_WAIT = COPY + """        }
        cp_async_wait_all();
        __syncwarp();
"""
PRODUCT = """#pragma unroll
        for (int kt = 0; kt < BW_KT; ++kt) {
          if (kt < ktn) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const uint32_t* bp = bs + (j * 8 + g) * SW + kt * 8;
              const uint32_t b0r = bp[0], b1r = bp[4];
              mma_bf16(acc[0][j], wf[0][kt], b0r, b1r);
              mma_bf16(acc[1][j], wf[1][kt], b0r, b1r);
            }
          }
        }
"""
RELEASE = "    if (tid == 0) st_release(flag_r + blockIdx.x, tag0 + (unsigned)i + 1u);\n"
DXP = "    // dxp after the flag, so that the release does not wait for it\n"
COEFS = "    // the next step's coefficients, while the flag travels\n"
STORES = "    // every thread's exchange stores, then the block's flag;"
K6 = "constexpr int DW_BM"


def sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"lstm_train.cu has changed: no {old[:60]!r}")
    return text.replace(old, new, 1)


def cut(text: str, start: str, end: str):
    a = text.index(start)
    b = text.index(end, a)
    return text[:a] + text[b:], text[a:b]


def variants(src: str) -> dict[str, str]:
    out = {"kept": src}
    wait_body = WAIT.split("      if (NT == 2) {\n")[0]
    out["warp waits at every B"] = sub(
        sub(src, "if (NT == 2 ? polls : (warp == 0 && lane < (int)gridDim.x)) {", "if (polls) {"),
        WAIT.split(wait_body)[1], "      __syncwarp();\n")
    out["block waits at every B"] = sub(
        sub(src, "if (NT == 2 ? polls : (warp == 0 && lane < (int)gridDim.x)) {",
            "if (warp == 0 && lane < (int)gridDim.x) {"),
        WAIT.split(wait_body)[1], "      __syncthreads();\n")
    v, block = cut(src, DXP, COEFS)
    out["dxp before the flag"] = sub(v, STORES, block + STORES)
    v = sub(src, "      load_step(j, T - 1);\n", "")
    v = sub(v, "    coefficients(j);\n  }\n\n  // Rows beyond nb", "  }\n\n  // Rows beyond nb")
    v = sub(v, "    if (t >= 1) {\n#pragma unroll\n      for (int j = 0; j < NT; ++j) {\n"
            "        if (valid[j]) {\n          load_step(j, t - 1);",
            "    if (t >= 0) {\n#pragma unroll\n      for (int j = 0; j < NT; ++j) {\n"
            "        if (valid[j]) {\n          load_step(j, t);")
    v, _ = cut(v, COEFS, "  }\n}\n\n" + K6)
    out["coefficients after the carry"] = sub(
        v, "    float dg[NT][4];\n",
        "#pragma unroll\n    for (int j = 0; j < NT; ++j) coefficients(j);\n    float dg[NT][4];\n")
    out["no L2 prefetch"] = sub(
        src, 'asm volatile("prefetch.global.L2 [%0];\\n" : : "l"(p));', "(void)p;")
    out["fence + volatile store"] = sub(
        src, RELEASE, "    if (tid == 0) { __threadfence(); *(volatile unsigned*)(flag_r + "
        "blockIdx.x) = tag0 + (unsigned)i + 1u; }\n")
    out["relaxed polls, one fence"] = sub(src, POLL_LOOP, """        while ((int)(*(volatile const unsigned*)(flag_r + lane) - want) < 0) {
          if (++polled > BW_MAX_POLLS) __trap();
        }
        __threadfence();
""")
    out["copy through registers"] = sub(src, COPY, """          for (int b = 0; b < nb; b += 8) {
            uint4 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (b + e < nb) v[e] = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)(b + e) * G4));
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (b + e < nb) *reinterpret_cast<uint4*>(dst + (b + e) * SW) = v[e];
          }
""")
    v = sub(src, COPY_WAIT, """          for (int b = 0; b < min(nb, 8); ++b) cp_async16(dst + b * SW, src + (size_t)b * G4);
        }
        asm volatile("cp.async.commit_group;\\n" ::: "memory");
        if (lane < 2 * ktn) {
          for (int b = 8; b < nb; ++b) cp_async16(dst + b * SW, src + (size_t)b * G4);
        }
        asm volatile("cp.async.commit_group;\\n" ::: "memory");
""")
    out["product under the second copy"] = sub(v, PRODUCT, """#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j == 0) asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
          else asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
          __syncwarp();
#pragma unroll
          for (int kt = 0; kt < BW_KT; ++kt) {
            if (kt < ktn) {
              const uint32_t* bp = bs + (j * 8 + g) * SW + kt * 8;
              const uint32_t b0r = bp[0], b1r = bp[4];
              mma_bf16(acc[0][j], wf[0][kt], b0r, b1r);
              mma_bf16(acc[1][j], wf[1][kt], b0r, b1r);
            }
          }
        }
        asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
""")
    # cycle counters of thread 0 of block (0, 0), steps 1 .. T-1
    v = sub(src, "namespace {\n", "__device__ unsigned long long umx_prof[8];\nnamespace {\n")
    v = sub(v, "    const int t = T - 1 - i;\n", "    const int t = T - 1 - i;\n"
            "    const bool prof = blockIdx.x == 0 && blockIdx.y == 0 && tid == 0 && i > 0 && i < T;\n"
            "    long long q0 = clock64(), q1 = q0, q2 = q0, q3 = q0, q4 = q0, q5 = q0;\n")
    v = sub(v, "      if (NT == 2) {\n        __syncwarp();",
            "      q1 = clock64();\n      if (NT == 2) {\n        __syncwarp();")
    v = sub(v, "        cp_async_wait_all();\n        __syncwarp();\n",
            "        cp_async_wait_all();\n        __syncwarp();\n        q2 = clock64();\n")
    v = sub(v, "      // accumulator (unit mt*16 + g", "      q3 = clock64();\n      // accumulator (unit mt*16 + g")
    v = sub(v, "    if (i == T) {\n", "    q4 = clock64();\n    if (i == T) {\n")
    v = sub(v, DXP, "    q5 = clock64();\n" + DXP)
    v = sub(v, "      for (int j = 0; j < NT; ++j) coefficients(j);\n    }\n  }\n}\n",
            "      for (int j = 0; j < NT; ++j) coefficients(j);\n    }\n    if (prof) {\n"
            "      const long long q[7] = {q0, q1, q2, q3, q4, q5, clock64()};\n"
            "      for (int e = 0; e < 6; ++e) umx_prof[e] += q[e + 1] - q[e];\n"
            "      umx_prof[6] += 1;\n    }\n  }\n}\n")
    out["cycle counters"] = v + """
extern "C" int umx_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, umx_prof, sizeof(umx_prof));
  unsigned long long z[8] = {0};
  cudaMemcpyToSymbol(umx_prof, z, sizeof(z));
  return (int)e;
}
"""
    return out


def build_all(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from umx_tpu_torch import _build

    out_dir = _build.BUILD_DIR.parent / "chip_forms"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for k, (name, text) in enumerate(texts.items()):
        cu, so = out_dir / f"form_{k}.cu", out_dir / f"form_{k}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the form {name!r}:\n{log[-3000:]}")
        # the two K5 instantiations come first in the file, K6 last
        regs = [line.split("Used ")[1].split(" registers")[0] for line in log.splitlines()
                if "Used " in line and " registers" in line]
        spills = sum("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
                     for line in log.splitlines())
        print(f"{name}: registers {'/'.join(regs[:2])}, kernels with spills {spills}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.umx_lstm_bwd.argtypes = _build._SIGNATURES["umx_lstm_bwd"]
        lib.umx_lstm_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def runner(lib, dev, B: int, gates, cs, c0, whh, cts):
    """One sweep of ``lib``'s K5 over all chains and B <= 16 rows, buffers
    made as the wrapper makes them."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    RB = R * B
    dxp = torch.empty((T, RB, 4 * G), device=dev)
    dh0 = torch.empty((RB, G), device=dev)
    dgx = torch.empty(L.bwd_exchange_elems(R, G), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        dc = cts[2].clone()
        flags = torch.zeros(L.bwd_flag_words(R), dtype=torch.int32, device=dev)
        err = lib.umx_lstm_bwd(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), whh.data_ptr(), cts[0].data_ptr(),
            cts[1].data_ptr(), dc.data_ptr(), dxp.data_ptr(), dh0.data_ptr(), dgx.data_ptr(),
            flags.data_ptr(), T, R, B, G, 0, R, 0, B, 0, stream)
        S.require(err == 0, f"umx_lstm_bwd: CUDA error {err}")
        return dxp, dh0, dc

    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_forms: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    from umx_tpu_torch import _build
    from umx_tpu_torch.ops import lstm_cuda as L

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    libs = build_all(variants((_build.CSRC / "lstm_train.cu").read_text()))
    dev = torch.device("cuda")
    names = ("wait for the flags", "copy", "product", "partial sums + barrier",
             "cell + exchange stores + barrier + release", "dxp stores + next coefficients")
    for B in ROWS:
        (xp, whh, h0, c0, _), cts = S.train_inputs(dev, T, B, G, seed=B)
        _, _, _, gates, cs = L.lstm_merged_train_fwd(xp, whh, h0, c0, B)
        runs = {name: runner(lib, dev, B, gates, cs, c0, whh, cts) for name, lib in libs.items()}
        kept = [x.clone() for x in runs["kept"]()]
        for name, run in runs.items():
            S.require(all(torch.equal(a, b) for a, b in zip(run(), kept)),
                      f"the form {name!r} does not give the kept form's bits at B = {B}")
        for rnd in range(2):
            print(f"B = {B}, round {rnd}, us per step  [{smi}]: " + "; ".join(
                f"{name} {S.cuda_ms(run, 10) / (T + 1) * 1e3:.3f}" for name, run in runs.items()),
                flush=True)
        counters = (ctypes.c_ulonglong * 8)()
        libs["cycle counters"].umx_prof_read(counters)  # clears what the timing runs counted
        runs["cycle counters"]()
        torch.cuda.synchronize()
        libs["cycle counters"].umx_prof_read(counters)
        n = max(1, counters[6])
        print(f"B = {B}, cycles per step of one thread over {n} steps  [{smi}]: " + "; ".join(
            f"{what} {counters[e] / n:.0f}" for e, what in enumerate(names))
            + f"; sum {sum(counters[:6]) / n:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
