#!/usr/bin/env python3
"""The forms of the reverse-sweep kernel K5 and of the per-target recurrence
K9 that were tried beside the ones kept, and where a step of each kept form
goes.

    python3 chip_forms.py [k5] [k9]      (both when none is named)

Makes variants of ``umx_tpu_torch/csrc/lstm_train.cu`` by text substitution
(the source itself carries no switches), builds each with its own nvcc into
``build/chip_forms/`` (all in parallel), checks that every variant gives the
kept form's bits, and times them in turns in one process at the UMX-L
training width (T = 256, R = 8 chains, G = 512) at 1, 3, 6 and 16 rows per
chain: microseconds per step, two rounds.  One variant carries cycle
counters (``clock64`` of one thread of one block): the phases of a step.
The same for ``umx_tpu_torch/csrc/lstm_pertarget.cu`` at the UMX-L segment
shape (T = 2584, 8 chains, one row) at G = 512 and G = 256: the kept form at
every cluster size the card can place, the variants, and the phases of a
step.  A measurement aid beside ``chip_smoke.py``, not a check.  Needs one
CUDA GPU and exits non-zero without one.
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
        raise RuntimeError(f"the kernel source has changed: no {old[:60]!r}")
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


def build_all(texts: dict[str, str], entries=("umx_lstm_bwd",),
              tag: str = "form") -> dict[str, ctypes.CDLL]:
    from umx_tpu_torch import _build

    out_dir = _build.BUILD_DIR.parent / "chip_forms"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for k, (name, text) in enumerate(texts.items()):
        cu, so = out_dir / f"{tag}_{k}.cu", out_dir / f"{tag}_{k}.so"
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
        for entry in entries:
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
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


PT_LOOP = "  for (int t = 0; t < T; ++t) {\n"
PT_PREFETCH = "    if (active && KS > 0) {\n      wa0 = wt[0];\n      wa1 = wt[32];\n    }\n"
PT_PRODUCT = "    if (active) {\n      // -- product:"
PT_CELL = "      const float a0 = sigmoidf_("
PT_EXCHANGE = "      // -- exchange:"
PT_TAIL = "    // -- while the stores fly"
PT_LOOP_END = "        prefetch_l2(xn + 2 * x_step + 2 * (size_t)G);\n      }\n    }\n  }\n"
PT_PHASES = ("tile prefetch and wait for h", "product and the sums of its accumulators",
             "activations, swap and cell", "pack and asynchronous stores",
             "hs store and next x_proj loads")


def pertarget_variants(src: str) -> dict[str, str]:
    """Variants of ``lstm_pertarget.cu`` by text substitution."""
    out = {"kept": src}
    out["two accumulators"] = sub(
        sub(src, "mma_m16n8k16(acc[(q & 1) * 2], wf", "mma_m16n8k16(acc[0], wf"),
        "mma_m16n8k16(acc[(q & 1) * 2 + 1], wf", "mma_m16n8k16(acc[1], wf")
    out["no L2 prefetch"] = sub(
        src, 'asm volatile("prefetch.global.L2 [%0];\\n" : : "l"(p));', "(void)p;")
    out["first tiles asked for after the wait"] = sub(
        sub(src, PT_PREFETCH, ""), PT_PRODUCT, PT_PREFETCH + PT_PRODUCT)
    # timing only (the words land in the wrong places): one 8-byte store a lane
    # and destination instead of two 4-byte stores
    v = sub(src, "__device__ __forceinline__ int h_pos(int w)", """__device__ __forceinline__ void st_async_u64(uint32_t remote_addr, unsigned long long value,
                                             uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\\n"
               :
               : "r"(remote_addr), "l"(value), "r"(remote_bar)
               : "memory");
}
__device__ __forceinline__ int h_pos(int w)""")
    v = sub(v, "      if (sends && t + 1 < T) {\n", "      const uint32_t word_b = __shfl_sync("
            "0xffffffffu, mine | (other << 16), 8);\n      if (sends && lane < 16 && t + 1 < T) {\n")
    out["TIMING ONLY 8-byte stores"] = sub(
        v, "        st_async_u32(dst_h + nb * (uint32_t)HW * 4u, word, dst_bar + nb * 8u);\n",
        "        st_async_u64((dst_h & ~7u) + nb * (uint32_t)HW * 4u, "
        "((unsigned long long)word_b << 32) | word, dst_bar + nb * 8u);\n")
    # timing only: every other warp sends 16 bytes a destination (a quarter of the stores)
    v = sub(src, "__device__ __forceinline__ int h_pos(int w)", """__device__ __forceinline__ void st_async_v4(uint32_t remote_addr, uint32_t a, uint32_t b,
                                            uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %1, %2}, [%3];\\n"
               :
               : "r"(remote_addr), "r"(a), "r"(b), "r"(remote_bar)
               : "memory");
}
__device__ __forceinline__ int h_pos(int w)""")
    v = sub(v, "      if (sends && t + 1 < T) {\n", "      const uint32_t word_b = __shfl_sync("
            "0xffffffffu, mine | (other << 16), 8);\n"
            "      if (sends && (warp & 1) == 0 && lane < 16 && t + 1 < T) {\n")
    out["TIMING ONLY 16-byte stores"] = sub(
        v, "        st_async_u32(dst_h + nb * (uint32_t)HW * 4u, word, dst_bar + nb * 8u);\n",
        "        st_async_v4((dst_h & ~15u) + nb * (uint32_t)HW * 4u, word, word_b, "
        "dst_bar + nb * 8u);\n")
    # the hs store (of the step before) and the x_proj loads behind the step's mma
    v, block = cut(src, PT_TAIL, "  }\n\n  if (owner) {\n    hT[")
    v = sub(v, "  }\n\n  if (owner) {\n    hT[", "  }\n\n  if (owner) {\n"
            "    hs_r[(size_t)(T - 1) * h_step + u] = h_last;\n    hT[")
    v = sub(v, "      // -- exchange:", "      x0 = xn0;\n      x1 = xn1;\n      // -- exchange:")
    out["hs store and x_proj loads behind the mma"] = sub(
        v, "      // -- cell:", "      float xn0 = 0.0f, xn1 = 0.0f;\n" + block.replace(
            "x0 = xn[0]", "xn0 = xn[0]").replace("x1 = xn[2", "xn1 = xn[2").replace(
            "    if (owner) hs_r[(size_t)t * h_step + u]",
            "    if (owner && t > 0) hs_r[(size_t)(t - 1) * h_step + u]") + "      // -- cell:")
    # cycle counters of thread 0 of block (0, 0) (a cell lane), every step
    v = sub(src, "namespace {\n", "__device__ unsigned long long umx_prof[8];\nnamespace {\n")
    v = sub(v, PT_LOOP, PT_LOOP
            + "    const bool prof = blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;\n"
            "    long long q0 = clock64(), q1 = q0, q2 = q0, q3 = q0, q4 = q0;\n")
    v = sub(v, PT_PRODUCT, "    q1 = clock64();\n" + PT_PRODUCT)
    v = sub(v, PT_CELL, "      q2 = clock64();\n" + PT_CELL)
    v = sub(v, PT_EXCHANGE, "      q3 = clock64();\n" + PT_EXCHANGE)
    v = sub(v, PT_TAIL, "    q4 = clock64();\n" + PT_TAIL)
    v = sub(v, PT_LOOP_END, PT_LOOP_END[: -len("  }\n")] + "    if (prof) {\n"
            "      const long long q[6] = {q0, q1, q2, q3, q4, clock64()};\n"
            "      for (int e = 0; e < 5; ++e) umx_prof[e] += q[e + 1] - q[e];\n"
            "      umx_prof[6] += 1;\n    }\n  }\n")
    out["cycle counters"] = v + """
extern "C" int umx_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, umx_prof, sizeof(umx_prof));
  unsigned long long z[8] = {0};
  cudaMemcpyToSymbol(umx_prof, z, sizeof(z));
  return (int)e;
}
"""
    return out


def pertarget_forms(dev, smi: str) -> None:
    """K9: every cluster size the card places, the variants, a step's phases."""
    import torch

    from umx_tpu_torch import _build
    from umx_tpu_torch.ops import lstm_cuda as L

    entries = ("umx_lstm_pertarget", "umx_lstm_pertarget_clusters")
    libs = build_all(pertarget_variants((_build.CSRC / "lstm_pertarget.cu").read_text()),
                     entries, tag="k9")
    T9, n_targets, D = S.T_SEG, 4, 2
    for G in (S.G_HIDDEN, 256):
        g = torch.Generator(device=dev).manual_seed(G)
        x_proj = torch.randn((n_targets, T9, D, 4 * G), generator=g, device=dev)
        whh = (torch.randn((n_targets, D, G, 4 * G), generator=g, device=dev) / G**0.5).to(
            torch.bfloat16)
        h0 = 0.5 * torch.randn((n_targets, D, G), generator=g, device=dev)
        c0 = 0.5 * torch.randn((n_targets, D, G), generator=g, device=dev)
        outs = [torch.empty((n_targets, T9, D, G), device=dev),
                torch.empty((n_targets, D, G), device=dev), torch.empty((n_targets, D, G), device=dev)]
        stream = torch.cuda.current_stream().cuda_stream

        def runner(lib, cluster):
            units = L.pertarget_units_per_block(G, cluster)

            def run():
                err = lib.umx_lstm_pertarget(
                    x_proj.data_ptr(), whh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                    *(o.data_ptr() for o in outs), T9, n_targets, D, G, cluster, units, stream)
                S.require(err == 0, f"umx_lstm_pertarget: CUDA error {err}")
                return outs

            return run

        placeable = L._pertarget_placeable(torch.cuda.current_device(), G, n_targets * D)
        chosen, _, waves = L.pertarget_cluster_choice(G, n_targets * D, placeable)
        kept = [x.clone() for x in runner(libs["kept"], chosen)()]
        print(f"G = {G}: clusters held at once by size {placeable}; chosen {chosen} "
              f"({waves} wave(s))", flush=True)
        sizes = [cl for cl in placeable if L.pertarget_units_per_block(G, cl) <= L.PERTARGET_MAX_UNITS
                 and cl <= max(1, G // L.PERTARGET_MIN_UNITS)]
        print(f"G = {G}, kept form by cluster size, us per step (waves)  [{smi}]: " + "; ".join(
            f"{cl} x {L.pertarget_units_per_block(G, cl)} units "
            f"{S.cuda_ms(runner(libs['kept'], cl), 5) / T9 * 1e3:.3f} "
            f"({-(-n_targets * D // placeable[cl])})" for cl in sizes), flush=True)
        runs = {name: runner(lib, chosen) for name, lib in libs.items()}
        # the 16-byte variant pairs neighbouring warps: it needs blocks of 8 n units
        wide = "TIMING ONLY 16-byte stores"
        if 8 in sizes and L.pertarget_units_per_block(G, 8) % 8 == 0:
            runs[wide] = runner(libs[wide], 8)
            runs["kept, 8 blocks"] = runner(libs["kept"], 8)
        else:
            del runs[wide]
        for name, run in runs.items():
            same = all(torch.equal(a, b) for a, b in zip(run(), kept))
            # another number of accumulators is another order of summation
            S.require(same or name == "two accumulators" or name.startswith("TIMING ONLY"),
                      f"the form {name!r} does not give the kept form's bits at G = {G}")
        for rnd in range(2):
            print(f"G = {G}, cluster {chosen}, round {rnd}, us per step  [{smi}]: " + "; ".join(
                f"{name} {S.cuda_ms(run, 5) / T9 * 1e3:.3f}" for name, run in runs.items()),
                flush=True)
        counters = (ctypes.c_ulonglong * 8)()
        libs["cycle counters"].umx_prof_read(counters)  # clears what the timing runs counted
        runs["cycle counters"]()
        torch.cuda.synchronize()
        libs["cycle counters"].umx_prof_read(counters)
        n = max(1, counters[6])
        print(f"G = {G}, cluster {chosen}, cycles per step of one owner lane over {n} steps  "
              f"[{smi}]: " + "; ".join(f"{what} {counters[e] / n:.0f}"
                                      for e, what in enumerate(PT_PHASES))
              + f"; sum {sum(counters[:5]) / n:.0f}", flush=True)


def bwd_forms(dev, smi: str) -> None:
    """K5: the variants at 1, 3, 6 and 16 rows per chain, a step's phases."""
    import torch

    from umx_tpu_torch import _build
    from umx_tpu_torch.ops import lstm_cuda as L

    libs = build_all(variants((_build.CSRC / "lstm_train.cu").read_text()))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_forms: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda")
    which = [a.lower() for a in sys.argv[1:]] or ["k5", "k9"]
    if "k5" in which:
        bwd_forms(dev, smi)
    if "k9" in which:
        pertarget_forms(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
