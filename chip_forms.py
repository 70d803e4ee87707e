#!/usr/bin/env python3
"""The forms of the reverse-sweep kernel K5, of the per-target recurrence
K9, of the overlap-add K7 and of the Wiener reduce K2 that were tried beside
the ones kept, and where a step of each kept recurrence goes.

    python3 chip_forms.py [k5] [k9] [ola] [wiener_reduce] [scan] [k8]   (all when none is named)
    python3 chip_forms.py k11_streaming [earlier lstm_scan_train.cu ...]

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
step.  ``ola``: variants of ``csrc/ola.cu`` and its earlier form (one
output sample a thread, rows on the grid's y axis), each bit-equal to the
plain version, timed in turns at the 100 s track's shape (3 chunks of 60 s,
M = 8 and 16 rows), the kept form also with half and twice its grid and in
scalars.  ``wiener_reduce``: variants of ``csrc/wiener.cu``'s reduce and its
earlier form (pass 1 over 128-bin x 64-row blocks, a second launch summing
the partials), held to the kept form's bits (the earlier form, another
order of summation, within 1e-5), timed in turns in the three input modes
at the UMX-L segment shape (S = 4, T = 2584, F = 2049).  ``scan``: the
float32 recurrence K10, K10 with residuals and K11 in their two forms (W_hh
resident on the chip, or streamed from L2 each step) at the kernel table's
shapes, in turns.  ``k8``: the iSTFT kernel K8 at every n_fft = 1024 k up to
16384 on 8 rows of a 60 s segment, beside its plain version, torch.istft
and its bound, and at n_fft 4096 (48 rows of a segment) its mixed-radix
form (4 x 8 x 8 x 8) against the hand-scheduled one kept there, in turns
(that comparison alone: ``k8_4096``).
``k11_streaming [FILE ...]``: K11's streaming form at T 256, R 8, B 16 and G
512 and 640, in turns against earlier sources of ``csrc/lstm_scan_train.cu``
named on the command line (for example one written by ``git show
<commit>:umx_tpu_torch/csrc/lstm_scan_train.cu``), each held to the plain
version; a source whose kernel takes W_hh transposed gets the transposed
copy its wrapper made, made outside the timing.  A measurement aid
beside ``chip_smoke.py``, not a check.  Needs one CUDA GPU and exits
non-zero without one.
"""

from __future__ import annotations

import ctypes
import re
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
    """Each text built into its own library; ``entries`` are the entry
    points to bind, by name (the argtypes of ``_build``) or as a dict of
    name -> argtypes; a library binds those of them it has."""
    from umx_tpu_torch import _build

    if not isinstance(entries, dict):
        entries = {entry: _build._SIGNATURES[entry] for entry in entries}

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
        # in the order of the kernels in the file (lstm_train.cu: the two K5
        # instantiations, then K6)
        regs = [line.split("Used ")[1].split(" registers")[0] for line in log.splitlines()
                if "Used " in line and " registers" in line]
        spills = sum("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
                     for line in log.splitlines())
        print(f"{name}: registers {'/'.join(regs)}, kernels with spills {spills}", flush=True)
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in entries.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
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


# K7's earlier form: one output sample of one row a thread, grid
# (ceil(L / 256), M) with the rows on y
OLA_EARLIER = """#include <cuda_runtime.h>
namespace {
constexpr int BLOCK = 256;
__global__ void ola_normalized_kernel(const float* __restrict__ ys, const float* __restrict__ inv_sw,
                                      float* __restrict__ out, int n_chunks, int M, int seg,
                                      int stride, int L) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= L) return;
  const int m = blockIdx.y;
  const int tail = seg - stride;
  const int k = n / stride;
  const int j = n - k * stride;
  float v;
  if (k < n_chunks) {
    const float head = ys[((size_t)k * M + m) * seg + j];
    const float prev = (k > 0 && j < tail) ? ys[((size_t)(k - 1) * M + m) * seg + stride + j] : 0.0f;
    v = __fadd_rn(head, prev);
  } else {
    v = ys[((size_t)(n_chunks - 1) * M + m) * seg + stride + j];
  }
  out[(size_t)m * L + n] = __fmul_rn(v, inv_sw[n]);
}
}  // namespace
extern "C" int umx_ola_earlier(const float* ys, const float* inv_sw, float* out, int n_chunks, int M,
                               int seg, int stride, int L, void* stream) {
  const dim3 grid((L + BLOCK - 1) / BLOCK, M);
  ola_normalized_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ys, inv_sw, out, n_chunks, M, seg, stride, L);
  return (int)cudaGetLastError();
}
"""


# K7 with the rows outside: a warp walks its share once a row, so that it
# has three streams (head, tail, out) open at a time, and reads inv_sw
# through L1/L2 once a row
OLA_ROWS_OUTER = """template <int V>
__device__ __forceinline__ typename Vec<V>::T ld_cached(const float* p);
template <>
__device__ __forceinline__ float ld_cached<1>(const float* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float4 ld_cached<4>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <int V>
__device__ __forceinline__ void ola_share(const float* __restrict__ ys,
                                          const float* __restrict__ inv_sw,
                                          float* __restrict__ out, int n_chunks, int M, int seg,
                                          int stride, int L, int a, int b, int lane) {
  using W = Vec<V>;
  const int tail = seg - stride;
  const size_t chunk_step = (size_t)M * seg;
  for (int m = 0; m < M; ++m) {
    for (int n = a; n < b;) {
      const int k = n / stride;
      const int k0 = k * stride;
      const int e = k < n_chunks ? min(b, k0 + stride) : b;
      const float* head_run = ys + (size_t)k * chunk_step + (size_t)m * seg - k0;
      const float* prev_run = ys + (size_t)(k - 1) * chunk_step + (size_t)m * seg + stride - k0;
      float* out_row = out + (size_t)m * L;
#pragma unroll 4
      for (int s = n + lane * V; s < e; s += 32 * V) {
        const bool has_prev = k > 0 && s - k0 < tail;
        const typename W::T inv = ld_cached<V>(inv_sw + s);
        const typename W::T p = has_prev ? W::ld(prev_run + s) : W::zero();
        if (k < n_chunks) {
          W::st(out_row + s, W::combine(W::ld(head_run + s), p, inv));
        } else {
          W::st(out_row + s, W::scale(p, inv));
        }
      }
      n = e;
    }
  }
}

"""


def ola_variants(src: str) -> dict[str, str]:
    """Variants of ``ola.cu`` by text substitution, and the earlier form."""
    out = {"kept": src}
    out["one row at a time"] = sub(src, "constexpr int R_AHEAD = 8;", "constexpr int R_AHEAD = 1;")
    out["4 rows ahead"] = sub(src, "constexpr int R_AHEAD = 8;", "constexpr int R_AHEAD = 4;")
    v = sub(src, "T ld(const float* p) { return *p; }", "T ld(const float* p) { return __ldcs(p); }")
    v = sub(v, "void st(float* p, T v) { *p = v; }", "void st(float* p, T v) { __stcs(p, v); }")
    v = sub(v, "return *reinterpret_cast<const float4*>(p);",
            "return __ldcs(reinterpret_cast<const float4*>(p));")
    out["streaming hints"] = sub(v, "*reinterpret_cast<float4*>(p) = v; }",
                                 "__stcs(reinterpret_cast<float4*>(p), v); }")
    # the first form of the present design
    out["4 rows ahead, streaming hints"] = sub(
        out["streaming hints"], "constexpr int R_AHEAD = 8;", "constexpr int R_AHEAD = 4;")
    v, _ = cut(src, "// One warp's share [a, b) of every row", "__global__ void __launch_bounds__(THREADS)")
    out["rows outer"] = sub(v, "__global__ void __launch_bounds__(THREADS)",
                            OLA_ROWS_OUTER + "__global__ void __launch_bounds__(THREADS)")
    out["earlier form"] = OLA_EARLIER
    return out


def ola_forms(dev, smi: str) -> None:
    """K7: the variants and the earlier form at M = 8 and 16, in turns."""
    import torch

    from umx_tpu_torch import _build
    from umx_tpu_torch.ops import ola, ola_cuda

    P, I = ctypes.c_void_p, ctypes.c_int
    libs = build_all(ola_variants((_build.CSRC / "ola.cu").read_text()), {
        "umx_ola_normalized": _build._SIGNATURES["umx_ola_normalized"],
        "umx_ola_grid": _build._SIGNATURES["umx_ola_grid"],
        "umx_ola_earlier": [P, P, P, I, I, I, I, I, P]}, tag="ola")
    n_chunks, seg, stride = S.N_CHUNKS, S.SEG, S.STRIDE
    L = n_chunks * stride + seg - stride
    stream = torch.cuda.current_stream().cuda_stream
    grid = ctypes.c_int(0)
    S.require(libs["kept"].umx_ola_grid(ctypes.addressof(grid)) == 0, "umx_ola_grid")
    print(f"ola: {grid.value} blocks of {ola_cuda.THREADS} threads a launch", flush=True)
    for M in (8, 16):
        g = torch.Generator(device=dev).manual_seed(M)
        ys = torch.randn((n_chunks, M, seg), generator=g, device=dev)
        inv_sw = 1.0 / (torch.rand(L, generator=g, device=dev) + 0.5)
        out = torch.empty((M, L), device=dev)
        plain = ola.ola_normalized_plain(ys, inv_sw, stride)

        def runner(lib, blocks=None, vec=1):
            def run():
                if blocks is None:
                    err = lib.umx_ola_earlier(ys.data_ptr(), inv_sw.data_ptr(), out.data_ptr(),
                                              n_chunks, M, seg, stride, L, stream)
                else:
                    err = lib.umx_ola_normalized(ys.data_ptr(), inv_sw.data_ptr(), out.data_ptr(),
                                                 n_chunks, M, seg, stride, L, blocks, vec, stream)
                S.require(err == 0, f"ola: CUDA error {err}")
                return out
            return run

        blocks = ola_cuda.ola_blocks(L, 4, grid.value)
        runs = {name: runner(lib, None if name == "earlier form" else blocks)
                for name, lib in libs.items()}
        runs["kept, half the grid"] = runner(libs["kept"], max(1, blocks // 2))
        runs["kept, two blocks an SM"] = runner(libs["kept"], 2 * blocks)
        runs["kept, three blocks an SM (two waves)"] = runner(libs["kept"], 3 * blocks)
        runs["kept, scalars"] = runner(libs["kept"], ola_cuda.ola_blocks(L, 1, grid.value), 0)
        for name, run in runs.items():
            out.zero_()
            S.require(torch.equal(run(), plain), f"the ola form {name!r} is not bit-equal to plain")
        moved = S.nbytes(ys, inv_sw, out)
        # a yardstick of the card's rate for a mix of reads and writes: one
        # device copy that reads and writes half the kernel's bytes each
        src = torch.empty(moved // 8, device=dev)
        dst = torch.empty_like(src)
        runs["torch copy_ of the same bytes"] = lambda: dst.copy_(src)
        for rnd in range(2):
            print(f"ola M = {M} ({moved / 1e6:.0f} MB, bound {moved / S.HBM_BYTES_PER_S * 1e3:.4f} "
                  f"ms), round {rnd}, ms  [{smi}]: " + "; ".join(
                      f"{name} {S.cuda_ms(run, 20):.4f}" for name, run in runs.items()), flush=True)


# K2's earlier reduce: pass 1 over (128-bin x 64-row) blocks into partials,
# pass 2 summing the partials in order (a second launch)
REDUCE_EARLIER = """#include <cuda_runtime.h>
namespace {
constexpr int S = 4;
constexpr int BLOCK_F = 128;
__device__ __forceinline__ void unit_phasor(float re, float im, float* ure, float* uim) {
  const float a2 = re * re + im * im;
  const bool nz = a2 > 0.0f;
  const float rs = rsqrtf(nz ? a2 : 1.0f);
  *ure = nz ? re * rs : 1.0f;
  *uim = nz ? im * rs : 0.0f;
}
template <int MODE>
__global__ void reduce_partial_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                                      const float* __restrict__ masks, const float* __restrict__ inv_ma,
                                      float* __restrict__ partials, int T, int F, int t_chunk) {
  const int f = blockIdx.x * BLOCK_F + threadIdx.x;
  if (f >= F) return;
  const int chunk = blockIdx.y;
  const int t0 = chunk * t_chunk;
  const int t1 = min(T, t0 + t_chunk);
  const size_t TF = (size_t)T * F;
  float acc[4 * S];
#pragma unroll
  for (int i = 0; i < 4 * S; ++i) acc[i] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const size_t i = (size_t)t * F + f;
    if (MODE == 0) {
      const float x0r = a_re[i], x0i = a_im[i];
      const float x1r = a_re[TF + i], x1i = a_im[TF + i];
      const float ax0 = x0r * x0r + x0i * x0i;
      const float ax1 = x1r * x1r + x1i * x1i;
      const float cr = x0r * x1r + x0i * x1i;
      const float ci = x0i * x1r - x0r * x1i;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t mi = ((size_t)s * T + t) * 2 * F + f;
        const float m0 = masks[mi];
        const float m1 = masks[mi + F];
        const float m01 = m0 * m1;
        acc[4 * s + 0] += m0 * m0 * ax0;
        acc[4 * s + 1] += m1 * m1 * ax1;
        acc[4 * s + 2] += m01 * cr;
        acc[4 * s + 3] += m01 * ci;
      }
    } else if (MODE == 2) {
      const float inv = inv_ma[0];
      float u0r, u0i, u1r, u1i;
      unit_phasor(a_re[i], a_im[i], &u0r, &u0i);
      unit_phasor(a_re[TF + i], a_im[TF + i], &u1r, &u1i);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t c0 = (size_t)(2 * s) * TF + i;
        const float m0 = masks[c0] * inv;
        const float m1 = masks[c0 + TF] * inv;
        const float yr0 = m0 * u0r, yi0 = m0 * u0i;
        const float yr1 = m1 * u1r, yi1 = m1 * u1i;
        acc[4 * s + 0] += yr0 * yr0 + yi0 * yi0;
        acc[4 * s + 1] += yr1 * yr1 + yi1 * yi1;
        acc[4 * s + 2] += yr0 * yr1 + yi0 * yi1;
        acc[4 * s + 3] += yi0 * yr1 - yr0 * yi1;
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t c0 = (size_t)(2 * s) * TF + i;
        const float yr0 = a_re[c0], yi0 = a_im[c0];
        const float yr1 = a_re[c0 + TF], yi1 = a_im[c0 + TF];
        acc[4 * s + 0] += yr0 * yr0 + yi0 * yi0;
        acc[4 * s + 1] += yr1 * yr1 + yi1 * yi1;
        acc[4 * s + 2] += yr0 * yr1 + yi0 * yi1;
        acc[4 * s + 3] += yi0 * yr1 - yr0 * yi1;
      }
    }
  }
  float scale = 1.0f;
  if (MODE == 0) {
    const float inv = inv_ma[0];
    scale = inv * inv;
  }
  float* out = partials + (size_t)chunk * 4 * S * F + f;
#pragma unroll
  for (int r = 0; r < 4 * S; ++r) out[(size_t)r * F] = acc[r] * scale;
}
__global__ void reduce_sum_kernel(const float* __restrict__ partials, float* __restrict__ racc,
                                  int n_chunks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < n_chunks; ++k) s += partials[(size_t)k * n + i];
  racc[i] = s;
}
}  // namespace
extern "C" int umx_wiener_reduce_earlier(int mode, const float* a_re, const float* a_im,
                                         const float* masks, const float* inv_ma, float* partials,
                                         float* racc, int T, int F, int t_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (T + t_chunk - 1) / t_chunk;
  const dim3 grid((F + BLOCK_F - 1) / BLOCK_F, n_chunks);
  if (mode == 0) {
    reduce_partial_kernel<0><<<grid, BLOCK_F, 0, st>>>(a_re, a_im, masks, inv_ma, partials, T, F, t_chunk);
  } else if (mode == 1) {
    reduce_partial_kernel<1><<<grid, BLOCK_F, 0, st>>>(a_re, a_im, masks, inv_ma, partials, T, F, t_chunk);
  } else {
    reduce_partial_kernel<2><<<grid, BLOCK_F, 0, st>>>(a_re, a_im, masks, inv_ma, partials, T, F, t_chunk);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = 4 * S * F;
  reduce_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(partials, racc, n_chunks, n);
  return (int)cudaGetLastError();
}
"""
REDUCE_EARLIER_T_CHUNK = 64


# forms of the reduce that sum in another order than the kept one: held to
# it within 1e-5 instead of bit for bit
REDUCE_REORDERING = ("10 time lanes", "earlier form")


def reduce_variants(src: str) -> dict[str, str]:
    """Variants of ``wiener.cu``'s reduce by text substitution, and the
    earlier form."""
    out = {"kept": src}
    out["one row at a time"] = sub(src, "constexpr int RB_AHEAD = 2;", "constexpr int RB_AHEAD = 1;")
    out["4 rows ahead"] = sub(src, "constexpr int RB_AHEAD = 2;", "constexpr int RB_AHEAD = 4;")
    # at most 64 registers: the 4 blocks an SM that one wave needs at F = 2049
    out["register bound for 4 blocks an SM"] = sub(src, "__launch_bounds__(RB_THREADS)",
                                                   "__launch_bounds__(RB_THREADS, 4)")
    a = src.index("struct ReduceRow<MODE_MASKS, MT>")
    b = src.index("struct ReduceRow<MODE_Y, float>")
    rows = re.sub(r"= (a_re|a_im|masks|mags)\[([^\]]+)\];", r"= __ldcs(\1 + \2);", src[a:b])
    rows = re.sub(r"= to_f32\(masks\[([^\]]+)\]\);", r"= to_f32(__ldcs(masks + \1));", rows)
    out["streaming loads in every mode"] = src[:a] + rows + src[b:]
    v = src
    for old, new in (("__ldcs(a_re + c0)", "a_re[c0]"), ("__ldcs(a_im + c0)", "a_im[c0]"),
                     ("__ldcs(a_re + c0 + TF)", "a_re[c0 + TF]"),
                     ("__ldcs(a_im + c0 + TF)", "a_im[c0 + TF]")):
        v = sub(v, old, new)
    out["plain loads in every mode"] = v
    # 40 warps a block row of the grid: 39 warps an SM at F = 2049, 4 blocks
    # an SM at up to 51 registers
    v = sub(src, "constexpr int RB_LANES = 8;", "constexpr int RB_LANES = 10;")
    out["10 time lanes"] = sub(v, "__launch_bounds__(RB_THREADS)", "__launch_bounds__(RB_THREADS, 4)")
    out["earlier form"] = REDUCE_EARLIER
    return out


def reduce_forms(dev, smi: str) -> None:
    """K2's reduce: the variants and the earlier form in the three modes."""
    import torch

    from umx_tpu_torch import _build
    from umx_tpu_torch.config import WienerConfig
    from umx_tpu_torch.ops import wiener_cuda as W

    P, I = ctypes.c_void_p, ctypes.c_int
    libs = build_all(reduce_variants((_build.CSRC / "wiener.cu").read_text()), {
        "umx_wiener_reduce": _build._SIGNATURES["umx_wiener_reduce"],
        "umx_wiener_reduce_earlier": [I, P, P, P, P, P, P, I, I, I, P]}, tag="reduce")
    T, F = S.T_SEG, S.F_BINS
    g = torch.Generator(device=dev).manual_seed(1)
    xre = 30 * torch.randn((2, T, F), generator=g, device=dev)
    xim = 30 * torch.randn((2, T, F), generator=g, device=dev)
    masks = torch.rand((S.N_SRC, T, 2 * F), generator=g, device=dev)
    inv = W.inv_max_abs(xre, xim, 10.0)
    mags = torch.rand((S.N_SRC, 2, T, F), generator=g, device=dev) * 40
    yre, yim = W.wiener_planes_from_masks(xre, xim, masks, WienerConfig())
    yre, yim = (yre * inv).contiguous(), (yim * inv).contiguous()
    racc = torch.empty((4 * S.N_SRC, F), device=dev)
    n_part = -(-T // REDUCE_EARLIER_T_CHUNK)
    partials = torch.empty((n_part, 4 * S.N_SRC, F), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for mode, a_re, a_im, m in (("masks", xre, xim, masks), ("y", yre, yim, None),
                                ("mags", xre, xim, mags)):
        code, mp = W._MODES[mode], (m.data_ptr() if m is not None else None)

        def runner(lib, earlier):
            def run():
                if earlier:
                    err = lib.umx_wiener_reduce_earlier(
                        code, a_re.data_ptr(), a_im.data_ptr(), mp, inv.data_ptr(),
                        partials.data_ptr(), racc.data_ptr(), T, F, REDUCE_EARLIER_T_CHUNK, stream)
                else:
                    err = lib.umx_wiener_reduce(code, 0, a_re.data_ptr(), a_im.data_ptr(), mp,
                                                inv.data_ptr(), racc.data_ptr(), T, F, stream)
                S.require(err == 0, f"wiener reduce: CUDA error {err}")
                return racc
            return run

        runs = {name: runner(lib, name == "earlier form") for name, lib in libs.items()}
        kept = runs["kept"]().clone()
        plain = W.wiener_reduce_plain(mode, a_re, a_im, m, inv)
        err = S.max_err(kept, plain) / float(plain.abs().max())
        S.require(err <= 1e-5, f"the kept reduce disagrees with plain in mode {mode}: {err}")
        for name, run in runs.items():
            got = run()
            if name in REDUCE_REORDERING:
                e = S.max_err(got, kept) / float(kept.abs().max())
                S.require(e <= 1e-5, f"the reduce form {name!r} disagrees in mode {mode}: {e}")
            else:
                S.require(torch.equal(got, kept), f"the reduce form {name!r} changed the bits")
        read = S.nbytes(a_re, a_im) + (0 if m is None else S.nbytes(m))
        moved = read + S.nbytes(racc)
        print(f"wiener_reduce mode {mode}: vs plain {err:.3g} of max|racc|; {moved / 1e6:.0f} MB, "
              f"bound {moved / S.HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
        for rnd in range(2):
            print(f"wiener_reduce mode {mode}, round {rnd}, ms  [{smi}]: " + "; ".join(
                f"{name} {S.cuda_ms(run, 20):.4f}" for name, run in runs.items()), flush=True)


# K10's shapes of the kernel table (T, rows per chain, G, W_hh dtype) at 8
# chains, and K10 with residuals and K11 at the UMX-L training shape
SCAN_K10_SHAPES = ((S.T_SEG, 1, 512, "float32"), (S.T_SEG, 3, 512, "float32"),
                   (S.T_SEG, 6, 512, "float32"), (S.T_SEG, 1, 512, "bfloat16"),
                   (S.T_SEG, 1, 256, "float32"), (S.T_SEG, 1, 640, "float32"),
                   (S.T_SEG, 1, 18, "float32"), (S.T_TRAIN, S.B_TRAIN, 512, "float32"))
SCAN_TRAIN_SHAPE = (S.T_TRAIN, S.B_TRAIN, 512)


def scan_variants(src: str) -> dict[str, str]:
    """``csrc/lstm_scan.cu`` as kept, with the resident form's W_hh in
    registers for 9 and for 13 iterations of a part at every row tile (11
    kept up to 4 rows, 9 at 8 and 16), and with cycle
    counters in the resident kernel (threads 0 and 255 of block (0, 0),
    steps 1 .. T-1): the wait for h (the poll), the barrier after it, the
    product (with the first pass's tree and cells where there are two
    passes), the barrier after the last read of h, and the last pass's
    tree and cells with their stores."""
    out = {"kept": src}
    for kreg in (9, 13):
        out[f"W_hh {kreg} iterations in registers"] = sub(
            src, "return rt >= 8 ? 9 : 11;", f"return {kreg};")
    v = sub(src, "namespace {\n", "__device__ unsigned long long umx_prof[16];\nnamespace {\n")
    v = sub(v, "    float* hb = h_s;\n",
            "    float* hb = h_s;\n"
            "    const int slot = blockIdx.x == 0 && blockIdx.y == 0 && t > 0\n"
            "                         ? (tid == 0 ? 0 : tid == RS_THREADS - 1 ? 8 : -1) : -1;\n"
            "    long long q0 = clock64(), q1 = q0, q2 = q0, q3 = q0, q4 = q0;\n")
    v = sub(v, "    __syncthreads();\n\n#pragma unroll\n    for (int n = 0; n < NP; ++n) {\n",
            "    q1 = clock64();\n    __syncthreads();\n    q2 = clock64();\n\n"
            "#pragma unroll\n    for (int n = 0; n < NP; ++n) {\n")
    v = sub(v, "      if (n == NP - 1) __syncthreads();\n",
            "      if (n == NP - 1) {\n        q3 = clock64();\n        __syncthreads();\n"
            "        q4 = clock64();\n      }\n")
    v = sub(v, "#pragma unroll\n    for (int n = 0; n < NP; ++n) {\n#pragma unroll\n"
               "      for (int q = 0; q < 4; ++q) xv[n][q] = xn[n][q];\n",
            "    if (slot >= 0) {\n"
            "      const long long q[6] = {q0, q1, q2, q3, q4, clock64()};\n"
            "      for (int e = 0; e < 5; ++e) umx_prof[slot + e] += q[e + 1] - q[e];\n"
            "      umx_prof[slot + 7] += 1;\n    }\n"
            "#pragma unroll\n    for (int n = 0; n < NP; ++n) {\n#pragma unroll\n"
            "      for (int q = 0; q < 4; ++q) xv[n][q] = xn[n][q];\n")
    out["cycle counters"] = v + """
extern "C" int umx_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, umx_prof, sizeof(umx_prof));
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(umx_prof, z, sizeof(z));
  return (int)e;
}
"""
    return out


def scan_phases(dev, smi: str) -> None:
    """K10's resident form: the variants of :func:`scan_variants`, each
    bit-equal to the kept form (the register split does not change the
    order of a sum), timed in turns at R 8, G 512 at B 1 (T 1024) and at
    the training shape (T 256, B 16), and where a step of the kept form
    goes in cycles."""
    import torch

    from umx_tpu_torch import _build

    libs = build_all(scan_variants((_build.CSRC / "lstm_scan.cu").read_text()),
                     ("umx_lstm_scan",), tag="scan")
    stream = torch.cuda.current_stream().cuda_stream
    names = ("poll", "barrier (h in)", "product (and the first pass's tree and cells)",
             "barrier (h read)", "the last pass's tree and cells")
    for T, B in ((1024, 1), (S.T_TRAIN, S.B_TRAIN)):
        xp, whh, h0, c0, _ = S.scan_inputs(dev, T, B, 512, seed=B)
        RB, rt = 8 * B, 1 << (B - 1).bit_length()
        hs = torch.empty((T, RB, 512), device=dev)
        hT = torch.empty((RB, 512), device=dev)

        def run(lib):
            def go():
                c = c0.clone()
                hx = torch.zeros(8 * 2 * 16 * 512, dtype=torch.int64, device=dev)
                err = lib.umx_lstm_scan(1, xp.data_ptr(), whh.data_ptr(), 0, h0.data_ptr(),
                                        c.data_ptr(), hs.data_ptr(), hT.data_ptr(),
                                        hx.data_ptr(), T, 8, B, 512, 0, 8, 0, B, rt, 0, stream)
                S.require(err == 0, f"umx_lstm_scan: CUDA error {err}")
                return hs.clone(), hT.clone(), c
            return go

        runs = {name: run(lib) for name, lib in libs.items()}
        kept = runs["kept"]()
        for name, go in runs.items():
            S.require(all(torch.equal(a, b) for a, b in zip(go(), kept)),
                      f"the variant {name!r} does not give the kept form's bits at B = {B}")
        for rnd in range(2):
            print(f"lstm_scan resident, T {T}, B {B}, round {rnd}, us per step  [{smi}]: "
                  + "; ".join(f"{name} {S.cuda_ms(go, 5) / T * 1e3:.3f}"
                              for name, go in runs.items()), flush=True)
        counters = (ctypes.c_ulonglong * 16)()
        libs["cycle counters"].umx_prof_read(counters)
        runs["cycle counters"]()
        torch.cuda.synchronize()
        libs["cycle counters"].umx_prof_read(counters)
        for slot, who in ((0, "thread 0"), (8, "thread 255")):
            n = max(1, counters[slot + 7])
            print(f"lstm_scan resident, T {T}, B {B}, cycles per step of {who} of block (0, 0) "
                  f"over {n} steps  [{smi}]: " + "; ".join(
                      f"{what} {counters[slot + e] / n:.0f}" for e, what in enumerate(names))
                  + f"; sum {sum(counters[slot:slot + 5]) / n:.0f}", flush=True)


def scan_forms(dev, smi: str) -> None:
    """K10, K10 with residuals and K11 in their two forms (W_hh resident on
    the chip, or streamed from L2 each step) at the kernel table's shapes,
    in turns (streaming, resident, resident, streaming): ms and us a step,
    each form against the plain version."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    def turns(name, fns, steps):
        got = {f: [] for f in fns}
        order = ("streaming", "resident", "resident", "streaming")
        for f in order:
            if f in fns:
                got[f].append(S.cuda_ms(fns[f], 3))
        print(f"{name}: " + "; ".join(
            f"{f} {min(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)}; "
            f"{min(v) / steps * 1e3:.3f} us a step)" for f, v in got.items()) + f"  [{smi}]",
            flush=True)

    for T, B, G, dt in SCAN_K10_SHAPES:
        xp, whh, h0, c0, _ = S.scan_inputs(dev, T, B, G, seed=T + B + G, dtype=dt)
        forms = [f for f in L.SCAN_FORMS if f == "streaming" or G <= L.SCAN_RESIDENT_G_MAX]
        ref = L.lstm_scan_plain(xp, whh, h0, c0, B)
        errs = {}
        for f in forms:
            out = L.lstm_scan(xp, whh, h0, c0, B, _form=f)
            errs[f] = (max(S.max_err(a, b) for a, b in zip(out, ref)), L.lstm_scan.form)
        print(f"lstm_scan T {T}, R 8, B {B}, G {G}, W_hh {dt}: vs plain (form): {errs}", flush=True)
        turns(f"lstm_scan T {T}, B {B}, G {G}, {dt}",
              {f: (lambda f=f: L.lstm_scan(xp, whh, h0, c0, B, _form=f)) for f in forms}, T)
        del xp, whh, h0, c0, ref
    T, B, G = SCAN_TRAIN_SHAPE
    xp, whh, h0, c0, cts = S.scan_train_inputs(dev, T, B, G, seed=5)
    _, _, _, gates, cs = L.lstm_scan_train_fwd(xp, whh, h0, c0, B)
    ref = L.lstm_scan_bwd_step_plain(gates, cs, c0, whh, *cts, B)
    outs = {f: L.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B, _form=f) for f in L.SCAN_FORMS}
    print(f"lstm_scan_bwd_step T {T}, B {B}, G {G}: of max|out| vs plain "
          f"{ {f: max(S.rel_to_max(a, b) for a, b in zip(o, ref)) for f, o in outs.items()} }; "
          f"the forms bit-equal: "
          f"{all(torch.equal(a, b) for a, b in zip(outs['resident'], outs['streaming']))}",
          flush=True)
    turns(f"lstm_scan_train_fwd T {T}, B {B}, G {G}",
          {f: (lambda f=f: L.lstm_scan_train_fwd(xp, whh, h0, c0, B, _form=f)) for f in L.SCAN_FORMS}, T)
    turns(f"lstm_scan_bwd_step T {T}, B {B}, G {G}",
          {f: (lambda f=f: L.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B, _form=f))
           for f in L.SCAN_FORMS}, T)


K8_MIXED_AT_4096 = (
    ("    case 4: *smem = SMEM_BYTES; return (const void*)istft_ct2_kernel;\n",
     "    case 4: return (const void*)istft_ct2_mr_kernel<4>;\n"),
    ("  *threads = n_fft == NW ? THREADS : MR_THREADS;\n", "  *threads = MR_THREADS;\n"),
)


def k8_mixed_at_4096(dev, smi: str) -> None:
    """K8 at n_fft 4096 on 48 rows of a UMX-L segment (T 2584): the
    hand-scheduled 16 x 16 x 8 form kept there against the mixed-radix form
    the other sizes run (4 x 8 x 8 x 8), both built here from the same
    source, each held to the plain version, timed in turns."""
    import torch

    from umx_tpu_torch import _build
    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    src = (_build.CSRC / "istft_ct.cu").read_text()
    mixed = src
    for old, new in K8_MIXED_AT_4096:
        mixed = sub(mixed, old, new)
    libs = build_all({"hand-scheduled 16 x 16 x 8": src, "mixed-radix 4 x 8 x 8 x 8": mixed},
                     ("umx_istft_ct2", "umx_istft_ct2_capacity"), tag="k8")
    n, hop, rows, T = 4096, 1024, 48, S.T_SEG
    F = n // 2 + 1
    g = torch.Generator(device=dev).manual_seed(n)
    re_, im_ = (torch.randn((rows, T, F), generator=g, device=dev) for _ in range(2))
    w = hann_window(n, dev)
    table = istft_ct_cuda._table(n, dev)
    ref = istft_ct.istft_ct2_plain(re_, im_, n, hop, w)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib):
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        S.require(lib.umx_istft_ct2_capacity(n, ctypes.addressof(blocks),
                                             ctypes.addressof(smem)) == 0, "k8 capacity")
        per_row, hops_per_run = istft_ct_cuda.istft_run_plan(rows, T, blocks.value)
        out = torch.empty((rows, (T - 1) * hop + n), device=dev)

        def go():
            err = lib.umx_istft_ct2(re_.data_ptr(), im_.data_ptr(), table.data_ptr(),
                                    w.data_ptr(), out.data_ptr(), rows, T, F, n, hop, per_row,
                                    hops_per_run, stream)
            S.require(err == 0, f"umx_istft_ct2: CUDA error {err}")
            return out
        return go, smem.value

    runs = {name: run(lib) for name, lib in libs.items()}
    got = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        go = runs[name][0]
        err = S.max_err(go(), ref)
        S.require(err <= 1e-5, f"K8 {name} at n_fft 4096 is {err} off its plain version")
        got[name].append(S.cuda_ms(go, 10))
    print(f"istft_ct2 n_fft 4096 ({rows} rows x {T} frames), in turns: " + "; ".join(
        f"{name} {min(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)}; shared memory "
        f"{runs[name][1]} B a block)" for name, v in got.items()) + f"  [{smi}]", flush=True)


def k11_streaming(dev, smi: str, earlier: list[str]) -> None:
    """K11's streaming form at T 256, R 8, B 16, G 512 and 640 as kept,
    against the earlier sources named, in turns (kept, earlier..., then
    back): ms a sweep, each held to the plain version within 1e-4 of its
    largest entry."""
    from pathlib import Path

    import torch

    from umx_tpu_torch import _build
    from umx_tpu_torch.ops import lstm_cuda as L

    texts = {"kept": (_build.CSRC / "lstm_scan_train.cu").read_text()}
    texts.update({Path(f).name: Path(f).read_text() for f in earlier})
    new_sig = _build._SIGNATURES["umx_lstm_scan_bwd"]
    old_sig = new_sig[1:]  # before the form's flag
    libs = build_all(texts, {"umx_lstm_scan_bwd": new_sig}, tag="k11")
    for name, text in texts.items():
        if "int umx_lstm_scan_bwd(int resident" not in text:
            libs[name].umx_lstm_scan_bwd.argtypes = old_sig
    stream = torch.cuda.current_stream(dev).cuda_stream
    T, B = S.T_TRAIN, S.B_TRAIN
    for G in (512, 640):
        xp, whh, h0, c0, cts = S.scan_train_inputs(dev, T, B, G, seed=G)
        _, _, _, gates, cs = L.lstm_scan_train_fwd(xp, whh, h0, c0, B)
        ref = L.lstm_scan_bwd_step_plain(gates, cs, c0, whh, *cts, B)
        wt = whh.transpose(1, 2).contiguous()
        R = whh.shape[0]

        class Plan:
            form = None

        plan = L._scan_plan(Plan, "K11", gates, R, B, G, False, "streaming")

        def run(name):
            lib = libs[name]
            takes_wt = "const W* __restrict__ wt" in texts[name]
            resident = () if "int umx_lstm_scan_bwd(int resident" not in texts[name] else (0,)

            def go():
                dxp = torch.empty((T, R * B, 4 * G), device=dev)
                dh0 = torch.empty((R * B, G), device=dev)
                dc = cts[2].clone()
                hx = torch.zeros(L.scan_bwd_exchange_words(R, G), dtype=torch.int64, device=dev)
                for launched, (r0, nr, b0, nb, rt) in enumerate(plan):
                    err = lib.umx_lstm_scan_bwd(
                        *resident, gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
                        (wt if takes_wt else whh).data_ptr(), 0, cts[0].data_ptr(),
                        cts[1].data_ptr(), dc.data_ptr(), dxp.data_ptr(), dh0.data_ptr(),
                        hx.data_ptr(), T, R, B, G, r0, nr, b0, nb, rt, launched * T, stream)
                    S.require(err == 0, f"{name}: CUDA error {err}")
                return dxp, dh0, dc
            return go

        runs = {name: run(name) for name in libs}
        got = {name: [] for name in runs}
        for name in (*runs, *reversed(runs)):
            out = runs[name]()
            err = max(S.rel_to_max(a, b) for a, b in zip(out, ref))
            S.require(err <= 1e-4, f"K11 {name} at G {G} is {err} off its plain version")
            got[name].append(S.cuda_ms(runs[name], 3))
        wrapper = S.cuda_ms(lambda: L.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B,
                                                         _form="streaming"), 3)
        print(f"lstm_scan_bwd_step streaming, T {T}, R {R}, B {B}, G {G} ({len(plan)} launches), "
              f"in turns: " + "; ".join(
                  f"{name} {min(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)}; "
                  f"{min(v) / T * 1e3:.3f} us a step)" for name, v in got.items())
              + f"; the kept wrapper {wrapper:.4f} ms; a transposed copy of W_hh "
              f"{S.cuda_ms(lambda: whh.transpose(1, 2).contiguous(), 5):.4f} ms  [{smi}]",
              flush=True)
        del xp, whh, h0, c0, cts, gates, cs, ref, wt


def k8_sizes(dev, smi: str) -> None:
    """K8 at every n_fft = 1024 k up to 16384 on 8 rows of a 60 s segment
    (T = 2646000 / hop + 1 frames), against its plain version and
    ``torch.istft``, beside its bound (planes in, signal out, ~2.5 N log2 N
    operations a frame)."""
    import math

    import torch

    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    rows = S.ISTFT_ROWS
    for k in range(1, 17):
        n = 1024 * k
        hop, F = n // 4, n // 2 + 1
        T = S.SEG // hop + 1
        g = torch.Generator(device=dev).manual_seed(n)
        re = torch.randn((rows, T, F), generator=g, device=dev)
        im = torch.randn((rows, T, F), generator=g, device=dev)
        w = hann_window(n, dev)
        out = istft_ct_cuda.istft_ct2(re, im, n, hop, w)
        err = S.max_err(out, istft_ct.istft_ct2_plain(re, im, n, hop, w))
        form = istft_ct_cuda.istft_ct2.form
        spec = torch.complex(re, im).transpose(-1, -2).contiguous()
        spec.imag[:, 0] = 0.0
        spec.imag[:, -1] = 0.0
        ms = S.cuda_ms(lambda: istft_ct_cuda.istft_ct2(re, im, n, hop, w), 10)
        plain = S.cuda_ms(lambda: istft_ct.istft_ct2_plain(re, im, n, hop, w), 5)
        lib = S.cuda_ms(lambda: torch.istft(spec, n_fft=n, hop_length=hop, window=w, center=True,
                                            onesided=True, length=(T - 1) * hop), 5)
        bound = S.bound_ms(2 * rows * T * F * 4 + rows * ((T - 1) * hop + n) * 4,
                           rows * T * (2.5 * n * math.log2(n) + 2 * n), "f32")
        print(f"istft_ct2 n_fft {n} ({rows} rows x {T} frames): vs plain {err:.3g}; kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, torch.istft {lib:.4f} ms, bound {bound[0]:.4f} "
              f"ms by {bound[1]}; form (runs per row, hops per run, radices) {form}  [{smi}]",
              flush=True)
        del re, im, spec, out


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
    which = [a.lower() for a in sys.argv[1:] if not a.endswith(".cu")] or [
        "k5", "k9", "ola", "wiener_reduce", "scan", "k8"]
    if "k5" in which:
        bwd_forms(dev, smi)
    if "k9" in which:
        pertarget_forms(dev, smi)
    if "ola" in which:
        ola_forms(dev, smi)
    if "wiener_reduce" in which:
        reduce_forms(dev, smi)
    if "scan" in which:
        scan_forms(dev, smi)
    if "scan_phases" in which:
        scan_phases(dev, smi)
    if "k8" in which:
        k8_sizes(dev, smi)
    if "k8" in which or "k8_4096" in which:
        k8_mixed_at_4096(dev, smi)
    if "k11_streaming" in which:
        k11_streaming(dev, smi, [a for a in sys.argv[1:] if a.endswith(".cu")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
