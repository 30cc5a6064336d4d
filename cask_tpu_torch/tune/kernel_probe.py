"""Take apart what sets the time of the POH SpMM and SpMV, LELL, slab, DIA
and BDIA ring SpMM, BSR SpMM and BDIA SpMV kernels.

    python3 -m cask_tpu_torch.tune.kernel_probe [--slab | --poh-spmv | --lell | --dia-spmm
                                                 | --ring | --bsr-spmm | --bdia-spmv
                                                 | --types | --sass CHECKOUT]
    env PYTHONPATH=<another checkout> python3 <this checkout>/cask_tpu_torch/tune/kernel_probe.py

The second form times another checkout's kernels with this script (it uses
only entry points that every version of the port has), so two versions can
be compared in one run on one card.  Needs a CUDA device.  One line per
measurement, CUDA events, median of 10 samples of 3 calls:

- POH SpMM (``poh_spmm``) on ``power_law(1_000_000, avg_degree=12,
  seed=3)``, f32, at k = 4 and k = 32 (does the time follow the number of
  column passes?), the heaviest panel alone (its tiles as a one-panel plan:
  the least time of the panel's blocks), and ``random_uniform`` of the same
  size and nonzero count (hub rows and uneven panels against none).
- The same POH SpMM at k = 32 through variants of ``csrc/poh_spmm.cu``,
  each built from a text edit of the source into the build directory and
  called directly (Y zeroed per call, the kernel as it stands among them):
  without its shared-memory atomics (plain adds, racy: timing only),
  without its X gathers (a constant in place of each X element), without
  both, with only the slot stream and its sifting into the queues (over
  the row parts, and over one part), and with its partial sums added
  straight into Y by global atomics, with no row parts.  What each
  removes is what it costs.  A checkout whose source the edits do not fit
  skips them.
- Slab SpMM (``bdia_spmm_slab``) on ``fem_blocks(512, dof=4)`` at k = 128,
  f32 and f64, beside the cuSPARSE product (``torch.sparse_csr_tensor`` @ X,
  f32, TF32 off), and the f32 kernel's variants (through its own wrapper):
  without its tensor-core products, without its copies, with 4 stages,
  without the L2 evict-first hint on the slab stream, through the generic
  copy loops that the bf16 instantiations use, as 3xTF32 (without the
  lo·lo pass), with the lo parts cut toward zero in place of rounded, and
  both (the kernel of PRs 5-6).
  Each variant that computes the product also gives its normwise error
  against f64 on ``fem_blocks(16, dof=4)`` at k = 128, plain and with the
  12 mantissa bits below TF32's set in every value and X element (the
  TF32-sensitive case), beside the plain FP32 twin's error there.
- ``mma.sync`` m16n8k8 TF32 alone, every SM full of warps: the ceiling of
  the slab's products on this card.

``--slab`` runs only the f32 slab and its variants.

``--poh-spmv`` takes POH SpMV (B16) apart on the power law above, f32:
the entry ``poh_spmv(p, x)`` as it stands, then variants of
``csrc/poh_spmv.cu`` built from text edits (called directly, y zeroed per
call), each on two tables of work pieces (rows ``(panel, first tile, end
tile, cut)``: the split of every panel into ``ceil(8·SMs / panels)`` equal
parts that the earlier split-per-panel kernel launched, and pieces of about equal tile
count, at several caps) and on the heaviest piece of each alone: without
the match and peer reduction before each shared atomic (plain shared
atomics), without shared atomics at all (plain adds, racy: timing only),
without the x gathers (a constant in place of each x element), the slot
stream alone (no gathers, no atomics), and without the flush of the
partial sums into y.  The split-per-panel source first takes the pieces table in
place of its split rule (an edit of its first lines), so every variant
runs the same pieces.  On a source with a heavy-row table, also without
it (every slot through the shared atomics).

``--lell`` takes ``HybLell.spmv`` (B18) apart on the same power law, f32:
the entry, each tier's kernel alone through ``lell_lane_sums``, the two
launches in a row and the entry's PyTorch glue alone (where the entry has
glue: the lane sums given, the rest of the entry timed), as built and
through source variants: for the layer-serial source, every layer's values, then
indices, then x entries loaded before any use; for the redesigned one, the
register bound lifted or moved (128, 48 registers), other numbers of layers
a thread loads at once, and no x gathers.  Each variant's build prints its
registers and spill bytes.

``--dia-spmm`` takes the DIA SpMM kernel (B12-B15) apart, f32: the entry
``dia_spmm(p, X)`` on the FEM matrix's scalar-DIA plan (29 diagonals in
three runs of consecutive offsets) at k = 128 and 32 and on
``stencil_2d(1024)``'s plan (5 diagonals) at k = 32 and 128, beside the
cuSPARSE product of each, and through variants of ``csrc/dia_spmm.cu``
(the wrapper pointed at each): with X taken as 1 (the value loads alone),
with the values taken as 1 (the X loads alone), without the stores; for
the windowed kernel also at most 4 diagonals a chunk, 4 rows a thread and
other register bounds.  ``--ring`` does the same for the BDIA ring SpMM
(B4) on the FEM matrix's BDIA plan at k = 128: without value loads,
without X loads, the pair loops unrolled over the plan's 5 × 4 pairs, the
values of a pair loaded ahead of its X row, both; for the windowed kernel
chunks of 4 block offsets, fewer and more block rows a warp and no
register bound.  Each build names the registers and spill bytes of the
f32 kernels timed.  Both fit the source from before the window (``env
PYTHONPATH=<parent checkout> python3 cask_tpu_torch/tune/kernel_probe.py
--dia-spmm --ring``); a variant that does not fit a source is skipped.

``--bsr-spmm`` takes BSR SpMM (B7) apart on the FEM matrix's plan at
k = 128, f32, bf16 values and X, and bf16 values with an f32 X, beside the
cuSPARSE product in f32 and bf16 and a plain copy of X (the floor of the X
and Y streams): the entry as built and through variants of
``csrc/bsr_spmm.cu`` without value loads, without X loads, with the values
loaded as vectors (the kernel of scalar broadcast loads), other block row
counts a team, consecutive block rows a team, other block sizes and no
register bound.  ``--bdia-spmv`` does the same for BDIA SpMV (B1-B3) on the
FEM plan, f32, bf16 values with f32 x and f16 values and x (f16 y), beside
a plain ``copy_`` of the values: without value loads, without x loads, a
block's x components as one vector (the kernel of scalar loads), one
scalar x load a pair, a branch to scalar loads for blocks partly outside,
plain loads for x and 128-thread blocks.  Each build names the registers
and spill bytes of the kernels timed; both fit the sources from before
their redesign too (``env PYTHONPATH=<parent checkout>``).

``--types`` times every kernel at its headline size in each value type the
checkout's kernels take, f32 and f64 first, then bf16 and f16 with their
operand in the same half type and in f32: the block and banded kernels (B1-B6,
B8-B15: BDIA SpMV, the slab, the BDIA ring and scalar-DIA SpMM at k = 128 on
``fem_blocks(512, dof=4)``, DIA SpMV on ``stencil_2d(2048)``, DIA SpMM at
k = 32 on ``stencil_2d(1024)``), then B7 and B16-B18 (POH SpMV, POH SpMM at
k = 32 and ``HybLell.spmv`` on the power law above; BSR SpMM on the FEM
matrix at k = 128), so that two versions' times can be compared in one run;
a combination a version refuses prints its refusal.

``--sass CHECKOUT`` builds this checkout's kernels and another checkout's
(say the parent commit's, unpacked with ``git archive``) and compares the
SASS (``cuobjdump -sass``) of every kernel the two builds share,
instruction for instruction: a change that must leave some instantiations'
machine code as it was shows that it did.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

PL_N = 1_000_000
FEM_NX = 512  # fem_blocks(FEM_NX, dof=4): 1,048,576 rows

# text edits of csrc/poh_spmm.cu (old, new), combined into the variants below
_NO_ATOMICS = ("atomicAdd(acc + key * KC + cl, sum)", "acc[key * KC + cl] += sum")
_NO_GATHERS = ("__ldg(X + static_cast<int64_t>(qc[e]) * k + c0 + cl)", "static_cast<T>(qc[e] & 1)")
_NO_QUEUE = ("for (int s0 = 0; s0 < cnt; s0 += G * U)", "for (int s0 = 0; s0 < 0; s0 += G * U)")
_NO_ACC = ("  for (int i = threadIdx.x; i < rows * KC; i += kThreads) acc[i] = T(0);\n"
           "  __syncthreads();\n", "")
_ONE_PART = ("const int parts = static_cast<int>((R * row_bytes + budget - 1) / budget);",
             "const int parts = 1;")
_NO_ACC_BYTES = ("const int acc_bytes = static_cast<int>((RP * row_bytes + 127) / 128 * 128);",
                 "const int acc_bytes = 0;")
_NO_STORE = ("  __syncthreads();\n\n  const int64_t row0", "  return;\n  const int64_t row0")

# name -> the edits of a variant
POH_VARIANTS = {
    "as built": [],
    "no shared atomics": [_NO_ATOMICS],
    "no X gathers": [_NO_GATHERS],
    "no atomics, no gathers": [_NO_ATOMICS, _NO_GATHERS],
    "sift only (no queue work)": [_NO_QUEUE],
    "sift only, one pass (no row parts)": [_NO_QUEUE, _NO_ACC, _ONE_PART, _NO_ACC_BYTES,
                                           _NO_STORE],
    "global atomics, no row parts": [
        _NO_ACC, ("qr[pos] = r[i] - rp0;", "qr[pos] = r[i] + I * R;"),
        ("atomicAdd(acc + key * KC + cl, sum)", "if (key < m) atomicAdd(Y + key * k + c0 + cl, sum)"),
        _NO_STORE, _ONE_PART, _NO_ACC_BYTES],
}


# text edits of csrc/poh_spmv.cu.  The split-per-panel kernel splits each panel in
# `splits` equal parts; its first lines are edited to read the parts from a
# pieces table passed as panel_ptr, so each variant runs any table.
_PS_PIECES = ("""  const int I = blockIdx.x / splits;
  const int piece = blockIdx.x % splits;
  const int t_lo = __ldg(panel_ptr + I);
  const int nt = __ldg(panel_ptr + I + 1) - t_lo;
  const int ta = t_lo + static_cast<int>(static_cast<int64_t>(nt) * piece / splits);
  const int tb = t_lo + static_cast<int>(static_cast<int64_t>(nt) * (piece + 1) / splits);
""", """  const int I = __ldg(panel_ptr + 4 * blockIdx.x);
  const int ta = __ldg(panel_ptr + 4 * blockIdx.x + 1);
  const int tb = __ldg(panel_ptr + 4 * blockIdx.x + 2);
""")
_PS_NO_MATCH = ("""const unsigned peers = __match_any_sync(0xffffffffu, key);
        A prod[1] = {v[u] * xv[u]};
        reduce_peers(peers, prod);
        if (live && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {""",
                """A prod[1] = {v[u] * xv[u]};
        if (live) {""")
_PS_PLAIN_ADD = ("atomicAdd(acc + key, prod[0]);", "acc[key] += prod[0];")
_PS_NO_X = ("A(cask::widen(__ldg(x + col)))", "A(c[u] & 1)")
_PS_SINK = [("  for (int t = ta; t < tb; ++t) {",
             "  A sink = A(0);\n  for (int t = ta; t < tb; ++t) {"),
            ("""A prod[1] = {v[u] * xv[u]};
        if (live) {
          acc[key] += prod[0];""", """sink += v[u] * xv[u] + A(r[u]);
        if (false) {"""),
            ("  __syncthreads();\n\n  const int64_t row0",
             "  if (sink == A(-1234567)) y[threadIdx.x] = sink;\n  __syncthreads();\n\n"
             "  const int64_t row0")]
_PS_NO_FLUSH = ("if (s != A(0) && row0 + r < m) atomicAdd(y + row0 + r, s);",
                "if (s == A(-1234567) && row0 + r < m) y[row0 + r] = s;")

# text edits of the redesigned csrc/poh_spmv.cu (pieces and a heavy-row table)
_PN_PLAIN_ADD = ("red_shared(acc + r[u], prod);", "acc[r[u]] += prod;")
_PN_NO_X = ("A(cask::widen(__ldg(x + col)))", "A(c[u] & 1)")
_PN_SINK = [("        red_shared(acc + r[u], prod);", "        sink += prod + A(r[u]);"),
            ("  A heavy_sum = A(0), heavy_sum1 = A(0);",
             "  A heavy_sum = A(0), heavy_sum1 = A(0), sink = A(0);"),
            ("  __syncthreads();\n\n  // flush",
             "  if (sink == A(-1234567)) y[threadIdx.x] = sink;\n  __syncthreads();\n\n"
             "  // flush")]
_PN_NO_FLUSH = ("if (s != A(0) && row0 + r < m) atomicAdd(y + row0 + r, s);",
                "if (s == A(-1234567) && row0 + r < m) y[row0 + r] = s;")

# name -> alternative edit lists (the split-per-panel source's, the pieces one's):
# the first that fits the source is built
POH_SPMV_VARIANTS = {
    "as built": [[_PS_PIECES], []],
    "no match (plain shared atomics)": [[_PS_PIECES, _PS_NO_MATCH]],
    "no shared atomics (plain adds, racy)": [[_PS_PIECES, _PS_NO_MATCH, _PS_PLAIN_ADD],
                                             [_PN_PLAIN_ADD]],
    "no x gathers": [[_PS_PIECES, _PS_NO_X], [_PN_NO_X]],
    "slot stream alone": [[_PS_PIECES, _PS_NO_MATCH, _PS_PLAIN_ADD, _PS_NO_X, *_PS_SINK],
                          [_PN_NO_X, *_PN_SINK]],
    "no global flush": [[_PS_PIECES, _PS_NO_FLUSH], [_PN_NO_FLUSH]],
}

# text edit of the layer-serial csrc/lell_spmv.cu: every layer's values, then
# indices, then x entries loaded before any use (8 layers at a time)
_LELL_OLD_LOOP = """    for (int ell = 0; ell < L; ++ell) {
      const T v = T(cask::widen(__ldcs(vals + ell * plane + off)));
      if (v != T(0)) {
        const int64_t col = static_cast<int64_t>(__ldcs(idx + ell * plane + off)) * B + b;
        if (col >= 0 && col < n) acc = fma_t(v, T(cask::widen(__ldg(x + col))), acc);
      }
    }"""
_LELL_BATCHED = """    for (int e0 = 0; e0 < L; e0 += 8) {
      T v[8], xv[8];
      int c[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = e0 + e < L ? T(cask::widen(__ldcs(vals + (e0 + e) * plane + off))) : T(0);
#pragma unroll
      for (int e = 0; e < 8; ++e) c[e] = v[e] != T(0) ? __ldcs(idx + (e0 + e) * plane + off) : -1;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int64_t col = static_cast<int64_t>(c[e]) * B + b;
        xv[e] = (c[e] >= 0 && col < n) ? T(cask::widen(__ldg(x + col))) : T(0);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fma_t(v[e], xv[e], acc);
    }"""
# and of the redesigned one (a warp per slot row, kChunk layers at a time)
def _lell_chunks(rows: int, hub: int):
    """The edit that makes the grouped and hub tiers load ``rows`` and
    ``hub`` layers at a time (f64 half that)."""
    return [("constexpr int kRowsChunk = sizeof(T) == 8 ? 3 : 6;",
             f"constexpr int kRowsChunk = sizeof(T) == 8 ? {max(rows // 2, 1)} : {rows};"),
            ("constexpr int kHubChunk = sizeof(T) == 8 ? 2 : 4;",
             f"constexpr int kHubChunk = sizeof(T) == 8 ? {max(hub // 2, 1)} : {hub};")]


def _lell_blocks(b: int):
    """The edit that holds the tier kernels to ``b`` resident blocks an SM
    (0: no register bound)."""
    bounds = "__launch_bounds__(kThreads, kMinBlocks)"
    return [(bounds + "\nlell_rows_kernel",
             (bounds.replace("kMinBlocks", str(b)) if b else "__launch_bounds__(kThreads)")
             + "\nlell_rows_kernel"),
            (bounds + "\nlell_hub_kernel",
             (bounds.replace("kMinBlocks", str(b)) if b else "__launch_bounds__(kThreads)")
             + "\nlell_hub_kernel")]


LELL_VARIANTS = {
    "as built": [],
    "every layer's loads before any use": [[(_LELL_OLD_LOOP, _LELL_BATCHED)]],
    "no register bound": [_lell_blocks(0)],
    "at most 128 registers": [_lell_blocks(2)],
    "at most 48 registers": [_lell_blocks(5)],
    "3 grouped, 2 hub layers at a time": [_lell_chunks(3, 2)],
    "4 grouped, 4 hub layers at a time": [_lell_chunks(4, 4)],
    "8 grouped, 4 hub layers at a time, no register bound": [
        _lell_chunks(8, 4) + _lell_blocks(0)],
    "no x gathers": [[("acc[j] = fma_t(v[e][j], T(cask::widen(__ldg(x + col))), acc[j]);",
                       "acc[j] = fma_t(v[e][j], T(c[e][j] & 1), acc[j]);")]],
}


# text edits of csrc/dia_spmm.cu: the kernel that loads per row and diagonal
# (the first of each pair) and the windowed one (the second)
_DIA_NO_X = [[("cask::load_vec<X, VEC>(Xm + j * k + static_cast<int64_t>(c) * VEC, xv);",
               "for (int e = 0; e < VEC; ++e) xv[e] = A(1);")],
             [("cask::load_vec<X, VEC>(xc + j * k, xw[w]);",
               "for (int e = 0; e < VEC; ++e) xw[w][e] = A(1);")]]
_DIA_NO_VALS = [[("const A a = A(cask::widen(__ldg(v + static_cast<int64_t>(d) * m_pad)));",
                  "const A a = A(1);")],
                [("cask::load_span_shared<V, kRows>(vd + dd * kTile, v);",
                  "for (int q = 0; q < kRows; ++q) v[q] = A(1);")]]
# the stores dropped, every sum kept live through a test of their total
_DIA_NO_STORE = [[("cask::store_vec<O, VEC>(Y + i * k + static_cast<int64_t>(c) * VEC, acc);",
                   "A s_ = A(0);\n    for (int e = 0; e < VEC; ++e) s_ += acc[e];\n"
                   "    if (s_ == A(-1234567)) Y[i] = O(s_);")],
                 [("cask::store_vec<O, VEC>(Y + (i0 + q) * k + static_cast<int64_t>(c) * VEC, "
                   "acc[q]);", "A s_ = A(0);\n          for (int e = 0; e < VEC; ++e) s_ += acc[q][e];"
                   "\n          if (s_ == A(-1234567)) Y[i0 + q] = O(s_);")]]
_BOUNDS2 = "__launch_bounds__(kThreads, 2)"
DIA_VARIANTS = {
    "as built": [],
    "values only (X taken as 1)": _DIA_NO_X,
    "X loads only (values taken as 1)": _DIA_NO_VALS,
    "no stores": _DIA_NO_STORE,
    "chunks of at most 4 diagonals": [[("return sizeof(A) == 8 ? 4 : 8;",
                                        "return sizeof(A) == 8 ? 2 : 4;")]],
    "4 rows a thread": [[("constexpr int kRows = 8;", "constexpr int kRows = 4;")]],
    "no register bound (one block an SM)": [[(_BOUNDS2, "__launch_bounds__(kThreads)")]],
    "at most 80 registers (three blocks an SM)": [[(_BOUNDS2, "__launch_bounds__(kThreads, 3)")]],
}

# text edits of csrc/bdia_spmm.cu: the kernel that walks the pairs one X row
# at a time (first) and the windowed one (second)
_RING_OLD_LOOPS = ("    for (int dp = 0; dp < ndiag; ++dp) {\n", "      for (int c = 0; c < bc; ++c) {\n")
_RING_UNROLLED = [(_RING_OLD_LOOPS[0], "#pragma unroll\n    for (int dp = 0; dp < 5; ++dp) {\n"),
                  (_RING_OLD_LOOPS[1], "#pragma unroll\n      for (int c = 0; c < 4; ++c) {\n")]
_RING_HOISTED = [("""        A xv[VEC];
        cask::load_vec<X, VEC>(Xm + col * k + static_cast<int64_t>(cv) * VEC, xv);
        const V* vj = v + static_cast<int64_t>(dp * bc + c) * tile;
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          if (r0 + q < br) {
            const A a = A(cask::widen(__ldg(vj + q * r_stride)));""",
                  """        const V* vj = v + static_cast<int64_t>(dp * bc + c) * tile;
        A av[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q)
          av[q] = r0 + q < br ? A(cask::widen(__ldg(vj + q * r_stride))) : A(0);
        A xv[VEC];
        cask::load_vec<X, VEC>(Xm + col * k + static_cast<int64_t>(cv) * VEC, xv);
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          if (r0 + q < br) {
            const A a = av[q];""")]
RING_VARIANTS = {
    "as built": [],
    "no value loads (values taken as 1)": [
        [("const A a = A(cask::widen(__ldg(vj + q * r_stride)));", "const A a = A(1);")],
        [("cask::load_span_shared<V, RB>(vj + r * npairs * kTile, v);",
          "for (int q = 0; q < RB; ++q) v[q] = A(1);")]],
    "no X loads (X taken as 1)": [
        [("cask::load_vec<X, VEC>(Xm + col * k + static_cast<int64_t>(cv) * VEC, xv);",
          "for (int e = 0; e < VEC; ++e) xv[e] = A(1);")],
        [("cask::load_vec<X, VEC>(xc + col * k, xw[w]);",
          "for (int e = 0; e < VEC; ++e) xw[w][e] = A(1);")]],
    "dp and c loops unrolled over 5 x 4 pairs": [_RING_UNROLLED],
    "values loaded ahead of the X row": [_RING_HOISTED],
    "unrolled, values ahead of the X row": [_RING_UNROLLED + _RING_HOISTED],
    "chunks of at most 4 block offsets": [[("constexpr int kChunk = 2;",
                                            "constexpr int kChunk = 4;")]],
    "half the register budget (fewer block rows a warp)": [[("* VEC * a > 84", "* VEC * a > 42")]],
    "twice the budgets (more block rows a warp)": [[
        ("r * BR > 16", "r * BR > 32"), ("* VEC * a > 84", "* VEC * a > 168"),
        ("r * BR * static_cast<int>(sizeof(V)) > 64", "r * BR * static_cast<int>(sizeof(V)) > 128")]],
    "no register bound (one block an SM)": [[(_BOUNDS2, "__launch_bounds__(kThreads)")]],
}


def _both(first, second):
    """A variant's alternatives: both edits where the source holds both
    kernels, else the first alone (the source from before the second)."""
    return [[first, second], [first]]


# text edits of csrc/bsr_spmm.cu: the kernel of scalar broadcast value loads
# (the fallback since the staged kernel) and the staged one.  Every sum
# stays live: a value or X element taken as a constant differs by output
# row or column.
_BSR_BLOCK = "static constexpr int kThreads = sizeof(X) == 2 ? 64 : 256;"
BSR_VARIANTS = {
    "as built": [],
    "no value loads (values taken as row + 1)": _both(
        ("const T a = T(cask::widen(__ldg(vw + static_cast<int64_t>(q) * kb)));",
         "const T a = T(q + 1);"),
        ("cask::load_span_shared<V, CB>(vb + r * kb + s * BC + c0, a);",
         "for (int c = 0; c < CB; ++c) a[c] = A(r + c + 1);")),
    "no X loads (X taken as column + 1)": _both(
        ("cask::load_vec<X, VEC>(Xm + xr * k + static_cast<int64_t>(cv) * VEC, xv);",
         "for (int e = 0; e < VEC; ++e) xv[e] = T(e + 1);"),
        ("cask::load_vec<X, VEC>(xc + (xrow0 + c) * k, xv[c]);",
         "for (int e = 0; e < VEC; ++e) xv[c][e] = A(e + 1);")),
    # a row's bc = 4 values of a slot as one vector (the FEM plan's blocks),
    # in the kernel of scalar value loads as it was before the staged one
    # (the first edit matches a comment of that source only)
    "values loaded as vectors (bc taken as 4)": [[
        ("half of each warp would idle at k = 128.", "half of each warp would idle at k = 128."),
        ('#include "value_types.cuh"', '#include "band_window.cuh"\n#include "value_types.cuh"'),
        ("      for (int c = 0; c < bc; ++c) {\n        const int64_t xr = xrow0 + c;",
         "      T av[RB][4] = {};\n#pragma unroll\n      for (int q = 0; q < RB; ++q)\n"
         "        if (r0 + q < br) cask::load_span_shared<V, 4>(v + static_cast<int64_t>(q) * kb + s * 4,"
         " av[q]);\n#pragma unroll\n      for (int c = 0; c < 4; ++c) {\n"
         "        const int64_t xr = xrow0 + c;"),
        ("const T a = T(cask::widen(__ldg(vw + static_cast<int64_t>(q) * kb)));",
         "const T a = av[q][c];")]],
    "one block row a team": [[("constexpr int kMaxTurns = 4;", "constexpr int kMaxTurns = 1;")]],
    "8 block rows a team": [[("constexpr int kMaxTurns = 4;", "constexpr int kMaxTurns = 8;")]],
    "consecutive block rows a team": [[
        ("const int tb = u * Team<X>::kTeams + team;", "const int tb = team * turns + u;")]],
    "256-thread blocks for every X": [[(_BSR_BLOCK, _BSR_BLOCK.replace("64 : 256", "256 : 256"))]],
    "128-thread blocks for every X": [[(_BSR_BLOCK, _BSR_BLOCK.replace("64 : 256", "128 : 128"))]],
    "64-thread blocks for every X": [[(_BSR_BLOCK, _BSR_BLOCK.replace("64 : 256", "64 : 64"))]],
    "no register bound": [[("__launch_bounds__(Team<X>::kThreads, Team<X>::kMinBlocks)",
                            "__launch_bounds__(Team<X>::kThreads)")]],
}

# text edits of csrc/bdia_spmv.cu: the path of one scalar x load a pair
# (the whole kernel before the vector x, its BC = 0 path since) and the
# path that takes a block of x in one vector
_SPMV_VEC_LOOP = """      } else {
#pragma unroll
        for (int c = 0; c < BC; ++c) xb[c] = A(0);
      }"""
BDIA_SPMV_VARIANTS = {
    "as built": [],
    "no value loads (values taken as row + 1)": _both(
        ("acc[k] = fma_t(A(cask::widen(__ldcs(vj + k * r_stride))), xv, acc[k]);",
         "acc[k] = fma_t(A(k + 1), xv, acc[k]);"),
        ("acc[k] = fma_t(A(cask::widen(__ldcs(vj + k * r_stride))), xb[c], acc[k]);",
         "acc[k] = fma_t(A(k + 1), xb[c], acc[k]);")),
    "no x loads (x taken as component + 1)": _both(
        ("const A xv = (col >= 0 && col < n) ? A(cask::widen(__ldg(x + col))) : A(0);",
         "const A xv = (col >= 0 && col < n) ? A(c + 1) : A(0);"),
        ("load_block<X, BC>(x + col0, xb);", "for (int c = 0; c < BC; ++c) xb[c] = A(c + 1);")),
    # a block's bc = 4 x components as one vector load (the FEM plan's
    # blocks), in the kernel of scalar loads, blocks partly outside [0, n) as 0
    "x as one vector per block (bc taken as 4)": [[
        ('#include "value_types.cuh"', '#include "band_window.cuh"\n#include "value_types.cuh"'),
        ("""    for (int c = 0; c < bc; ++c) {
      const int64_t col = col0 + c;
      const A xv = (col >= 0 && col < n) ? A(cask::widen(__ldg(x + col))) : A(0);""",
         """    A xb[4];
    if (col0 >= 0 && col0 + 4 <= n) {
      cask::load_span_shared<X, 4>(x + col0, xb);
    } else {
      for (int c = 0; c < 4; ++c) xb[c] = A(0);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const A xv = xb[c];""")]],
    "one scalar x load a pair (as before the vector)": [[
        ("const bool whole = n % bc == 0 &&", "const bool whole = false &&")]],
    "a block of x partly outside [0, n) by scalar loads (a branch)": [[
        ("      if (col0 >= 0 && col0 < n) {\n        load_block<X, BC>(x + col0, xb);",
         "      if (col0 >= 0 && col0 + BC <= n) {\n        load_block<X, BC>(x + col0, xb);"),
        (_SPMV_VEC_LOOP, _SPMV_VEC_LOOP.replace(
            "xb[c] = A(0);",
            "xb[c] = col0 + c >= 0 && col0 + c < n ? A(cask::widen(__ldg(x + col0 + c))) : A(0);"))]],
    "x blocks by plain loads (not the read-only path)": [[
        (f"__ldg(reinterpret_cast<const {t}*>(p + s))", f"*reinterpret_cast<const {t}*>(p + s)")
        for t in ("uint4", "uint2", "unsigned", "unsigned short")]],
    "128-thread blocks": [[("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]],
}


def _ms(fn) -> float:
    from cask_tpu_torch.tune.timing import time_cuda

    return time_cuda(fn, warmup=3, runs=10, reps=3).ms


# name -> text edits of csrc/bdia_slab_spmm.cu: the f32 kernel without its
# tensor-core products (only the copies, barriers and stores stay), without
# its copies (products on whatever shared memory holds), with the bf16
# types' copy loops in place of its own, and without the 4xTF32 kernel's
# lo·lo pass, its rounded lo parts, or both (the kernel of PRs 5-6)
_LOLO = ("            for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], alo[i], blo[j]);",
         "            for (int j = 0; j < kJ; ++j) {}")
SLAB_VARIANTS = {
    "as built": [],
    "3xTF32 (no lo*lo pass)": [_LOLO],
    "lo cut toward zero (as PRs 5-6)": [(
        "(kRound ? 0x1000u : 0u)", "0u")],
    "3xTF32, lo cut (PRs 5-6)": [_LOLO, (
        "(kRound ? 0x1000u : 0u)", "0u")],
    "no products": [_LOLO,
                    ("            for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], alo[i], bhi[j]);",
                     "            for (int j = 0; j < kJ; ++j) {}"),
                    ("            for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);",
                     "            for (int j = 0; j < kJ; ++j) {}"),
                    ("          for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);",
                     "          for (int j = 0; j < kJ; ++j) {}")],
    "4 stages": [("constexpr int kTcStages = 3;", "constexpr int kTcStages = 4;"),
                 ("constexpr int kTableMax = 2048;", "constexpr int kTableMax = 512;")],
    "no L2 evict-first hint on the slabs": [
        ('asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" : "=l"(once));',
         'asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\\n" : "=l"(once));')],
    "no copies": [('  asm volatile("cp.async.cg.shared.global.L2::cache_hint',
                   '  if (0) asm volatile("cp.async.cg.shared.global.L2::cache_hint'),
                  ('  asm volatile("cp.async.cg.shared.global [',
                   '  if (0) asm volatile("cp.async.cg.shared.global ['),
                  ('  asm volatile("cp.async.ca.shared.global [',
                   '  if (0) asm volatile("cp.async.ca.shared.global [')],
    "f32 through the generic copy loops": [(
        "if constexpr (sizeof(S) == 4 && sizeof(X) == 4) {", "if constexpr (false) {")],
}


def _build_variants(source: str, variants: dict, focus: str = None) -> dict:
    """{name: path of the built library} of the text-edited variants of
    ``csrc/<source>.cu`` that fit it, all compiled at once; ``focus``: a
    pattern of the kernels (mangled names) whose registers each build
    names."""
    from cask_tpu_torch.ops.kernels import build

    src = (build.CSRC / f"{source}.cu").read_text()
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(variants.items()):
        # a variant is one list of edits, or alternative lists (the first that fits)
        for alt in (edits if edits and isinstance(edits[0], list) else [edits]):
            text = src
            for old, new in alt:  # in order: an edit may match the text of an earlier one
                if old not in text:
                    break
                text = text.replace(old, new)
            else:
                cu = out / f"{source}_v{i}.cu"
                cu.write_text(text)
                jobs[name] = (cu.with_suffix(".so"), _nvcc(cu))
                break
        else:
            print(f"[probe] variant '{name}' does not fit this source: skipped", flush=True)
    return {name: _wait(so, proc, name, focus) for name, (so, proc) in jobs.items()}


def _nvcc(cu):
    from cask_tpu_torch.ops.kernels import build

    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(cu.with_suffix(".so")), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(so, proc, name, focus=None):
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"'{name}' failed to build:\n{log}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))
    if regs:
        own = "" if focus is None else "; " + ", ".join(
            f"{re.search(focus, f).group(0)} {r} registers, {sp} spill bytes"
            for f, r, sp in _entries(log) if re.search(focus, f))
        print(f"[probe] built '{name}': {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"spill bytes {spills}{own}", flush=True)
    return so


def _entries(log: str):
    """(mangled kernel name, registers, spill bytes) of each entry function
    in an ``nvcc -Xptxas -v`` log."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", part))
        out.append((part.split("'", 1)[0], int(regs.group(1)) if regs else 0, spills))
    return out


def _poh_variants():
    """{name: ctypes f32 entry} of the POH SpMM source variants."""
    p, i_, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for name, so in _build_variants("poh_spmm", POH_VARIANTS).items():
        fn = ctypes.CDLL(str(so)).cask_poh_spmm_f32
        fn.argtypes, fn.restype = [p] * 7 + [i_, i_, i_, i_, ll, ll, i_, p], ctypes.c_int
        fns[name] = fn
    return fns


def _mma_peak() -> float:
    """TFLOP/s of mma.sync m16n8k8 TF32 alone: every SM full of warps, each
    with 8 independent accumulators."""
    import torch
    from cask_tpu_torch.ops.kernels import build

    cu = build.BUILD_DIR / "probe" / "mma_peak.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(MMA_PEAK_CU)
    lib = ctypes.CDLL(str(_wait(cu.with_suffix(".so"), _nvcc(cu), "mma_peak")))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")

    def run():
        if lib.run(out.data_ptr(), blocks, iters, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("mma_peak launch failed")
    ms = _ms(run)
    return blocks * 8 * iters * 8 * 2048 / (ms * 1e-3) / 1e12


MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1.0f - threadIdx.x * 1e-3f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int iters, void* stream) {
  mma_peak<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _sparse_csr(a, dev, dtype=None):
    """The BSR or CSR matrix as a torch sparse CSR tensor on ``dev``, f32
    unless ``dtype`` names another type."""
    import numpy as np
    import torch

    from cask_tpu_torch.formats.convert import to_scipy

    s = to_scipy(a).tocsr()
    return torch.sparse_csr_tensor(torch.from_numpy(s.indptr.astype(np.int32)),
                                   torch.from_numpy(s.indices.astype(np.int32)),
                                   torch.from_numpy(s.data.astype(np.float32)).to(
                                       dtype or torch.float32),
                                   size=s.shape).to(dev)


def _error_cases(dev):
    """(name, slab plan, X) of the slab's error-class check: fem_blocks(16,
    dof=4) f32 at k = 128, plain and TF32-sensitive (the 12 mantissa bits
    below TF32's set in every value and X element)."""
    import dataclasses

    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.generate import fem_blocks
    from cask_tpu_torch.ops.bdia_slab import slab_auto_plan

    def low(v):
        bits = v.view(np.int32).copy()
        bits[v != 0] |= 0x0FFF
        return bits.view(np.float32)

    base = fem_blocks(16, dof=4, dtype=np.float32, return_bsr=True)
    x = np.random.default_rng(55).standard_normal((base.shape[1], 128)).astype(np.float32)
    out = []
    for name, bsr, xh in (("headline-shaped", base, x),
                          ("TF32-sensitive", dataclasses.replace(
                              base, data=low(np.asarray(base.data))), low(x))):
        out.append((name, slab_auto_plan(ct.bdia_plan(bsr, device=dev)),
                    torch.from_numpy(xh).to(dev)))
    return out


def _slab_error(name, sl, x) -> str:
    """The slab kernel's and its plain FP32 twin's normwise errors against
    f64 on one case, and their ratio."""
    import dataclasses

    import torch

    from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                              bdia_spmm_slab_reference)

    exact = bdia_spmm_slab_reference(dataclasses.replace(sl, slabs=sl.slabs.double()),
                                     x.double())
    y = bdia_spmm_slab(sl, x)
    torch.cuda.synchronize()
    twin = bdia_spmm_slab_reference(sl, x)

    def err(v):
        return float((v.double() - exact).norm() / exact.norm())

    e_k, e_t = err(y), err(twin)
    return f"{name} {e_k:.3e} (twin {e_t:.3e}, {e_k / e_t:.2f}x)"


def _one_panel(p, i: int):
    """Panel ``i``'s tiles as a plan of their own (R rows)."""
    ptr = p.panel_ptr.cpu()
    ta, tb = int(ptr[i]), int(ptr[i + 1])
    cut = {f: getattr(p, f)[ta:tb] for f in ("vals", "cloc", "rloc", "wlo", "whi", "first",
                                             "last")}
    return type(p)(panel=p.panel[ta:tb] * 0, shape=(p.row_panel, p.shape[1]),
                   row_panel=p.row_panel, col_window=p.col_window, **cut)


def _split_pieces(p, sms: int):
    """The pieces of the split-per-panel kernel's rule: every panel in
    ``ceil(8·SMs / panels)`` equal parts (at most ntiles), panel-major, as
    ``(panel, first tile, end tile, 1)`` rows."""
    import numpy as np
    import torch

    ptr = p.panel_ptr.cpu().numpy().astype(np.int64)
    splits = max(1, min(-(-8 * sms // p.n_panels), p.ntiles))
    rows = [(i, ptr[i] + (ptr[i + 1] - ptr[i]) * j // splits,
             ptr[i] + (ptr[i + 1] - ptr[i]) * (j + 1) // splits, 1)
            for i in range(p.n_panels) for j in range(splits)]
    return torch.tensor(rows, dtype=torch.int32, device=p.vals.device), splits


def _poh_spmv_probe(dev, gen) -> None:
    """``--poh-spmv``: POH SpMV's entry and source variants on the power law."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.generate import power_law
    from cask_tpu_torch.ops.kernels import build
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmv, spmm_pieces

    parent_form = "int splits" in (build.CSRC / "poh_spmv.cu").read_text()
    libs = _build_variants("poh_spmv", POH_SPMV_VARIANTS)
    a = power_law(PL_N, avg_degree=12, dtype=np.float32, seed=3)
    p = ct.poh_plan(a, device=dev)
    x = torch.randn(PL_N, generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split, splits = _split_pieces(p, sms)
    cap = -(-p.ntiles // (8 * sms))
    tables = {f"split {splits} per panel": split}
    for c in (cap // 2, cap, 2 * cap, 4 * cap):
        tables[f"pieces of <= {c} tiles"] = spmm_pieces(p.panel_ptr, c)
    per = torch.diff(p.panel_ptr).cpu().numpy()
    print(f"[probe] poh_spmv power_law: {p.ntiles} tiles, {p.n_panels} panels, tiles per "
          f"panel {per.min()}-{per.max()} (mean {per.mean():.1f}), fill {p.fill():.3f}; "
          + ", ".join(f"{name}: {t.shape[0]} pieces, largest "
                      f"{int((t[:, 2] - t[:, 1]).max())} tiles" for name, t in tables.items()),
          flush=True)
    print(f"[probe] poh_spmv entry poh_spmv(p, x) as built: "
          f"{_ms(lambda: poh_spmv(p, x)) * 1e3:.1f} us", flush=True)
    S = _sparse_csr(a, dev)
    print(f"[probe] cuSPARSE (torch.sparse_csr_tensor @ x) float32: "
          f"{_ms(lambda: S @ x) * 1e3:.1f} us", flush=True)
    del S
    heavy = getattr(p, "heavy_row", None)
    none = None if heavy is None else torch.full_like(heavy, -1)
    P, I_, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    runs = []  # (variant label, entry, heavy-row table)
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).cask_poh_spmv_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([P] * 7 + [I_] * 5 + [LL, LL, P]) if parent_form else \
            ([P] * 8 + [I_] * 4 + [LL, LL, P])
        runs.append((name, fn, heavy))
        if name == "as built" and heavy is not None:
            one = heavy.clone()
            one[:, 1:] = -1
            runs += [("the heaviest row alone in registers", fn, one),
                     ("no heavy-row table (every slot a shared atomic)", fn, none)]
    for vname, fn, hv in runs:
        for tname, table in tables.items():
            def call(fn=fn, table=table, hv=hv):
                y = torch.zeros(PL_N, device=dev)
                common = (p.vals.data_ptr(), p.cloc.data_ptr(), p.rloc.data_ptr(),
                          p.wlo.data_ptr(), table.data_ptr())
                tail = (p.row_panel, p.col_window, p.slot_rows * 128, PL_N, PL_N,
                        torch.cuda.current_stream().cuda_stream)
                if parent_form:
                    err = fn(*common, x.data_ptr(), y.data_ptr(), table.shape[0], 1, *tail)
                else:
                    err = fn(*common, hv.data_ptr(), x.data_ptr(), y.data_ptr(),
                             table.shape[0], *tail)
                if err:
                    raise RuntimeError(f"variant '{vname}': CUDA error {err}")
            big = table[int((table[:, 2] - table[:, 1]).argmax())][None].contiguous()
            print(f"[probe] poh_spmv variant '{vname}', {tname} (y zeroed per call): "
                  f"{_ms(call) * 1e3:.1f} us; its largest piece alone "
                  f"{_ms(lambda: call(table=big)) * 1e3:.1f} us", flush=True)


def _lell_probe(dev, gen) -> None:
    """``--lell``: ``HybLell.spmv``'s parts and the source variants."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    import cask_tpu_torch.ops.kernels.lell_kernels as lk
    from cask_tpu_torch.formats.generate import power_law
    from cask_tpu_torch.ops.kernels import build

    libs = _build_variants("lell_spmv", LELL_VARIANTS)
    a = power_law(PL_N, avg_degree=12, dtype=np.float32, seed=3)
    h = ct.lell_plan_hyb(a, device=dev)
    x = torch.randn(PL_N, generator=gen, device=dev)
    m, hub = h.main, h.hub
    print(f"[probe] lell power_law: grouped tier {tuple(m.vals.shape)} (G {m.groups}, fill "
          f"{m.fill():.3f}), hub tier {tuple(hub.vals.shape)} (fill {hub.fill():.3f}), "
          f"remainder {m.rem_data.shape[0]}", flush=True)

    def parts(tag):
        grouped = lambda: lk.lell_lane_sums(m.vals, m.idx, x, m.groups)  # noqa: E731
        hubs = lambda: lk.lell_lane_sums(hub.vals, hub.idx, x, 1)  # noqa: E731
        for what, fn in (("entry HybLell.spmv", lambda: h.spmv(x)),
                         ("grouped tier kernel alone", grouped),
                         ("hub tier kernel alone", hubs),
                         ("both tiers' kernels", lambda: (grouped(), hubs()))):
            print(f"[probe] lell {tag} {what}: {_ms(fn) * 1e3:.1f} us", flush=True)

    parts("as built,")
    if hasattr(type(m), "_spmv") and hasattr(type(hub), "_partial"):
        sm, sh = (lk.lell_lane_sums(m.vals, m.idx, x, m.groups),
                  lk.lell_lane_sums(hub.vals, hub.idx, x, 1))
        glue = lambda: m._spmv(x, lambda *_: sm) + hub._partial(x, lambda *_: sh)  # noqa: E731
        print(f"[probe] lell as built, the entry's glue alone (lane sums given): "
              f"{_ms(glue) * 1e3:.1f} us", flush=True)
    else:
        print("[probe] lell as built: the entry has no PyTorch glue", flush=True)
    S = _sparse_csr(a, dev)
    print(f"[probe] cuSPARSE (torch.sparse_csr_tensor @ x) float32: "
          f"{_ms(lambda: S @ x) * 1e3:.1f} us", flush=True)
    del S
    load = build.load  # the wrapper pointed at each variant's library in turn
    try:
        for vname, so in libs.items():
            build.load = lambda name, so=so: ctypes.CDLL(str(so))
            lk._lib.cache_clear()
            parts(f"variant '{vname}',")
    finally:
        build.load = load
        lk._lib.cache_clear()


def _with_variants(source: str, cached_lib, libs: dict, run) -> None:
    """``run(variant name)`` for each built variant of ``csrc/<source>.cu``,
    with the wrapper's library (``cached_lib``, an ``lru_cache``d loader)
    pointed at it."""
    from cask_tpu_torch.ops.kernels import build

    load = build.load
    try:
        for vname, so in libs.items():
            build.load = lambda name, so=so: ctypes.CDLL(str(so)) if name == source else load(name)
            cached_lib.cache_clear()
            run(vname)
    finally:
        build.load = load
        cached_lib.cache_clear()


def _runs(offsets) -> str:
    """The plan's offsets as their runs of consecutive values."""
    runs = []
    for o in offsets:
        if runs and o == runs[-1][1] + 1:
            runs[-1][1] = o
        else:
            runs.append([o, o])
    return " | ".join(f"{a}..{b}" if a != b else f"{a}" for a, b in runs)


def _dia_spmm_probe(dev, gen) -> None:
    """``--dia-spmm``: the DIA SpMM entry and its source variants on the FEM
    matrix's scalar-DIA plan at k = 128 and 32 and the stencil's at 32 and
    128, f32."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    import cask_tpu_torch.ops.kernels.dia_kernels as dk
    from cask_tpu_torch.formats.generate import fem_blocks, stencil_2d
    from cask_tpu_torch.ops.bdia import bdia_scalar_dia

    libs = _build_variants("dia_spmm", DIA_VARIANTS, focus=r"dia_spmm_kernelIfffLi4ELi(8|32)E")
    fem = fem_blocks(FEM_NX, dof=4, dtype=np.float32, seed=0, return_bsr=True)
    st = stencil_2d(1024, dtype=np.float32)
    scalar = bdia_scalar_dia(ct.bdia_plan(fem, device=dev))
    stencil = ct.dia_plan(st, device=dev)
    for name, p in (("FEM scalar-DIA", scalar), ("stencil_2d(1024)", stencil)):
        print(f"[probe] dia_spmm {name} plan: {p.shape[0]} rows, {p.ndiags} diagonals, runs "
              f"{_runs(p.offsets)}", flush=True)
    cases = [("FEM scalar-DIA k=128", scalar, fem, 128), ("FEM scalar-DIA k=32", scalar, fem, 32),
             ("stencil k=32", stencil, st, 32), ("stencil k=128", stencil, st, 128)]
    X = {k: torch.randn((scalar.shape[1], k), generator=gen, device=dev) for k in (32, 128)}
    for label, _, a, k in cases:
        S = _sparse_csr(a, dev)
        print(f"[probe] dia_spmm {label}: cuSPARSE (torch.sparse_csr_tensor @ X) "
              f"{_ms(lambda: S @ X[k]) * 1e3:.1f} us", flush=True)
        del S

    def run(vname):
        for label, p, _, k in cases:
            print(f"[probe] dia_spmm {label}, variant '{vname}': "
                  f"{_ms(lambda: dk.dia_spmm(p, X[k])) * 1e3:.1f} us", flush=True)
    _with_variants("dia_spmm", dk._lib, libs, run)


def _ring_probe(dev, gen) -> None:
    """``--ring``: the BDIA ring SpMM entry and its source variants on the
    FEM matrix's BDIA plan at k = 128, f32."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    import cask_tpu_torch.ops.kernels.bdia_kernels as bk
    from cask_tpu_torch.formats.generate import fem_blocks

    libs = _build_variants("bdia_spmm", RING_VARIANTS, focus=r"bdia_spmm_kernelIfffLi4ELi4E")
    fem = fem_blocks(FEM_NX, dof=4, dtype=np.float32, seed=0, return_bsr=True)
    p = ct.bdia_plan(fem, device=dev)
    print(f"[probe] ring FEM plan: {p.nbr} block rows, blocks {p.blocksize}, block offsets "
          f"{_runs(p.block_offsets)}, {p.npairs} pairs", flush=True)
    X = torch.randn((p.shape[1], 128), generator=gen, device=dev)
    S = _sparse_csr(fem, dev)
    print(f"[probe] ring k=128: cuSPARSE (torch.sparse_csr_tensor @ X) "
          f"{_ms(lambda: S @ X) * 1e3:.1f} us", flush=True)
    del S
    fits = len(p.block_offsets) == 5 and p.blocksize[1] == 4  # the unrolled variants' counts

    def run(vname):
        if "unrolled" in vname and not fits:
            print(f"[probe] ring variant '{vname}': not this plan's pair count", flush=True)
            return
        print(f"[probe] ring k=128, variant '{vname}': "
              f"{_ms(lambda: bk.bdia_spmm_ring(p, X)) * 1e3:.1f} us", flush=True)
    _with_variants("bdia_spmm", bk._mm_lib, libs, run)


def _bsr_spmm_probe(dev, gen) -> None:
    """``--bsr-spmm``: the BSR SpMM entry and its source variants on the FEM
    matrix at k = 128: f32, bf16 values and X, bf16 values with f32 X."""
    import dataclasses

    import numpy as np
    import torch

    import cask_tpu_torch.ops.kernels.bsr_kernels as bk
    from cask_tpu_torch.formats.generate import fem_blocks
    from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel

    libs = _build_variants("bsr_spmm", BSR_VARIANTS, 
                          focus=r"(?<=\d)bsr_spmm_\w*?kernelI(fff|13__nv_bfloat16S1_S1_"
                                r"|13__nv_bfloat16fS1_)Li4E")
    fem = fem_blocks(FEM_NX, dof=4, dtype=np.float32, seed=0, return_bsr=True)
    p = BsrSpmmKernel.plan(fem, 128, device=dev)
    ph = dataclasses.replace(p, vals=p.vals.to(torch.bfloat16))
    print(f"[probe] bsr_spmm FEM plan: {p.n_block_rows} block rows, blocks {p.blocksize}, "
          f"G {p.G}, K {p.K}", flush=True)
    X = torch.randn((p.shape[1], 128), generator=gen, device=dev)
    Xh = X.to(torch.bfloat16)
    for dt, x in ((torch.float32, X), (torch.bfloat16, Xh)):
        S = _sparse_csr(fem, dev, dt)
        print(f"[probe] bsr_spmm k=128: cuSPARSE (torch.sparse_csr_tensor {str(dt)[6:]} @ X "
              f"{str(dt)[6:]}) {_ms(lambda: S @ x) * 1e3:.1f} us", flush=True)
        del S
    for x in (X, Xh):  # the floor of the X and Y streams: a plain copy of X's bytes
        y = torch.empty_like(x)
        nbytes = x.numel() * x.element_size()
        ms = _ms(lambda: y.copy_(x))
        print(f"[probe] bsr_spmm k=128: plain copy_ of X {str(x.dtype)[6:]} ({nbytes / 1e6:.1f} "
              f"MB read and written) {ms * 1e3:.1f} us, {2 * nbytes / ms / 1e6:.0f} GB/s",
              flush=True)
        del y
    cases = (("f32", p, X), ("bf16 . bf16", ph, Xh), ("bf16 values, f32 X", ph, X))

    def run(vname):
        for label, q, x in cases:
            print(f"[probe] bsr_spmm k=128 {label}, variant '{vname}': "
                  f"{_ms(lambda: bk.bsr_spmm(q, x)) * 1e3:.1f} us", flush=True)
    _with_variants("bsr_spmm", bk._lib, libs, run)


def _bdia_spmv_probe(dev, gen) -> None:
    """``--bdia-spmv``: the BDIA SpMV entry and its source variants on the
    FEM matrix's BDIA plan: f32, bf16 values with f32 x, f16 values and x
    (f16 y); beside each, a plain ``copy_`` of the value bytes."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    import cask_tpu_torch.ops.kernels.bdia_kernels as bk
    from cask_tpu_torch.formats.generate import fem_blocks

    libs = _build_variants("bdia_spmv", BDIA_SPMV_VARIANTS, 
                          focus=r"(?<=\d)bdia_spmv_\w*?kernelI(fff|13__nv_bfloat16ff"
                                r"|6__halfS1_S1_)Li4E")
    fem = fem_blocks(FEM_NX, dof=4, dtype=np.float32, seed=0, return_bsr=True)
    p = ct.bdia_plan(fem, device=dev)
    print(f"[probe] bdia_spmv FEM plan: {p.nbr} block rows, blocks {p.blocksize}, block "
          f"offsets {_runs(p.block_offsets)}, {p.npairs} pairs, tile {p.ts * 128}", flush=True)
    x = torch.randn(p.shape[1], generator=gen, device=dev)
    cases = (("f32", p, x), ("bf16 values, f32 x", p.astype(torch.bfloat16), x),
             ("f16 . f16, f16 y", p.astype(torch.float16), x.half()))
    for label, q, _ in cases:
        dst = torch.empty_like(q.vals)
        nbytes = q.vals.numel() * q.vals.element_size()
        ms = _ms(lambda: dst.copy_(q.vals))
        print(f"[probe] bdia_spmv {label}: plain copy_ of the values ({nbytes / 1e6:.1f} MB "
              f"read and written) {ms * 1e3:.1f} us, {2 * nbytes / ms / 1e6:.0f} GB/s",
              flush=True)
        del dst

    def run(vname):
        for label, q, v in cases:
            print(f"[probe] bdia_spmv {label}, variant '{vname}': "
                  f"{_ms(lambda: bk.bdia_spmv(q, v)) * 1e3:.1f} us", flush=True)
    _with_variants("bdia_spmv", bk._lib, libs, run)


def _time_or_refusal(name: str, tag: str, fn) -> None:
    """One ``[probe] types`` line: the call's time, or the version's refusal."""
    try:
        fn()
    except (TypeError, RuntimeError, ValueError) as e:
        print(f"[probe] types {name} {tag}: refused ({str(e).splitlines()[0][:100]})",
              flush=True)
        return
    print(f"[probe] types {name} {tag}: {_ms(fn) * 1e3:.1f} us", flush=True)


def _types_block_banded(dev, combos) -> None:
    """``--types``: B1-B6 and B8-B15 by value and operand type, on plans of
    the f32 matrices cast to each value type (bit-equal to planning the
    rounded matrix)."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.generate import fem_blocks, stencil_2d
    from cask_tpu_torch.ops.bdia import bdia_scalar_dia
    from cask_tpu_torch.ops.bdia_slab import slab_auto_plan
    from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_spmm_ring, bdia_spmv
    from cask_tpu_torch.ops.kernels.bdia_slab_kernels import bdia_spmm_slab
    from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmm, dia_spmv

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    fem = ct.bdia_plan(fem_blocks(FEM_NX, dof=4, dtype=np.float32, seed=0, return_bsr=True),
                       device=dev)
    big = ct.dia_plan(stencil_2d(2048, dtype=np.float32), device=dev)
    mid = ct.dia_plan(stencil_2d(1024, dtype=np.float32), device=dev)
    scalar = bdia_scalar_dia(fem)
    x = torch.randn(fem.shape[1], generator=gen, device=dev, dtype=torch.float64)
    xs = torch.randn(big.shape[1], generator=gen, device=dev, dtype=torch.float64)
    Xm = torch.randn((mid.shape[1], 32), generator=gen, device=dev, dtype=torch.float64)
    Xw = torch.randn((fem.shape[1], 128), generator=gen, device=dev, dtype=torch.float64)
    for vdt, xdt in combos:
        p, s, d, dm = (q.astype(vdt) for q in (fem, scalar, big, mid))
        sl = slab_auto_plan(p)
        xv, xsv, Xmv, Xwv = (t.to(xdt) for t in (x, xs, Xm, Xw))
        tag = f"values {str(vdt)[6:]}, operand {str(xdt)[6:]}"
        for name, fn in (("bdia_spmv", lambda: bdia_spmv(p, xv)),
                         ("dia_spmv", lambda: dia_spmv(d, xsv)),
                         ("dia_spmm k=32", lambda: dia_spmm(dm, Xmv)),
                         (f"bdia_spmm_slab k=128 (g {sl.g})", lambda: bdia_spmm_slab(sl, Xwv)),
                         ("bdia_spmm_ring k=128", lambda: bdia_spmm_ring(p, Xwv)),
                         ("dia_spmm k=128 (scalar DIA)", lambda: dia_spmm(s, Xwv))):
            _time_or_refusal(name, tag, fn)
        del p, s, d, dm, sl, xv, xsv, Xmv, Xwv


def _types(dev) -> None:
    """``--types``: every kernel by value and operand type."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.generate import fem_blocks, power_law
    from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
    from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmm, poh_spmv

    f32, f64, bf, f16 = torch.float32, torch.float64, torch.bfloat16, torch.float16
    combos = [(f32, f32), (f64, f64), (bf, bf), (bf, f32), (f16, f16), (f16, f32)]
    _types_block_banded(dev, combos)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pl = power_law(PL_N, avg_degree=12, dtype=np.float64, seed=3)
    fem = fem_blocks(FEM_NX, dof=4, dtype=np.float64, seed=0, return_bsr=True)
    x = torch.randn(PL_N, generator=gen, device=dev, dtype=f64)
    X = torch.randn((PL_N, 32), generator=gen, device=dev, dtype=f64)
    Xw = torch.randn((fem.shape[1], 128), generator=gen, device=dev, dtype=f64)
    plans = {}
    for vdt, xdt in combos:
        if vdt not in plans:  # each value type planned from its own matrix, as a user would
            a = pl.astype(np.float32 if vdt != f64 else np.float64).to(dev).astype(vdt)
            b = fem.astype(np.float32 if vdt != f64 else np.float64).to(dev).astype(vdt)
            plans[vdt] = (ct.poh_plan(a), ct.lell_plan_hyb(a), BsrSpmmKernel.plan(b, 128))
            del a, b
        p, h, q = plans[vdt]
        xv, Xv, Xwv = x.to(xdt), X.to(xdt), Xw.to(xdt)
        tag = f"values {str(vdt)[6:]}, operand {str(xdt)[6:]}"
        for name, fn in (("poh_spmv", lambda: poh_spmv(p, xv)),
                         ("poh_spmm k=32", lambda: poh_spmm(p, Xv)),
                         ("HybLell.spmv", lambda: h.spmv(xv)),
                         ("bsr_spmm k=128", lambda: bsr_spmm(q, Xwv))):
            _time_or_refusal(name, tag, fn)


def _sass_by_kernel(lib) -> dict:
    """{kernel: its SASS} of a built library, the anonymous namespace's
    source-hashed name dropped from each kernel's mangled name and the
    instruction offsets from its code."""
    from cask_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, body = part.split("\n", 1)
        funcs[re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", name.strip())] = \
            re.sub(r"/\*[0-9a-f]{4}\*/", "", body)
    return funcs


def _sass(other: str) -> None:
    """``--sass CHECKOUT``: this checkout's kernels against another's."""
    from cask_tpu_torch.ops.kernels import build

    other = os.path.abspath(other)
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    mine = build.build_all(names)
    code = ("import json, sys; from cask_tpu_torch.ops.kernels import build; "
            "print(json.dumps({n: str(p) for n, p in build.build_all(sys.argv[1:]).items()}))")
    out = subprocess.run([sys.executable, "-c", code, *names], cwd=other, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": other})
    theirs = json.loads(out.stdout.strip().splitlines()[-1])
    same, differ, new = 0, [], 0
    for name in names:
        a, b = _sass_by_kernel(theirs[name]), _sass_by_kernel(mine[name])
        for f, body in b.items():
            if f not in a:
                new += 1
            elif a[f] == body:
                same += 1
            else:
                differ.append(f)
    print(f"[probe] sass against {other}: {same} kernels in both builds identical, "
          f"{len(differ)} differ{': ' + ', '.join(differ) if differ else ''}; {new} only in "
          f"this checkout", flush=True)


def main() -> int:
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.generate import fem_blocks, power_law, random_uniform
    from cask_tpu_torch.ops.bdia_slab import slab_auto_plan
    import cask_tpu_torch.ops.kernels.bdia_slab_kernels as bsk
    from cask_tpu_torch.ops.kernels import build
    from cask_tpu_torch.ops.kernels.bdia_slab_kernels import bdia_spmm_slab
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmm

    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[probe] package {ct.__file__}; card {card}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if "--types" in sys.argv[1:]:
        _types(dev)
        return 0
    if "--sass" in sys.argv[1:]:
        _sass(sys.argv[sys.argv.index("--sass") + 1])
        return 0
    chosen = {"--poh-spmv": _poh_spmv_probe, "--lell": _lell_probe,
              "--dia-spmm": _dia_spmm_probe, "--ring": _ring_probe,
              "--bsr-spmm": _bsr_spmm_probe, "--bdia-spmv": _bdia_spmv_probe}
    if any(flag in sys.argv[1:] for flag in chosen):
        for flag, probe in chosen.items():
            if flag in sys.argv[1:]:
                probe(dev, gen)
        return 0
    slab_only = "--slab" in sys.argv[1:]

    variants = {} if slab_only else _poh_variants()
    slab_variants = _build_variants("bdia_slab_spmm", SLAB_VARIANTS)
    if slab_only:
        pl = ru = None
    else:
        pl = power_law(PL_N, avg_degree=12, dtype=np.float32, seed=3)
        ru = random_uniform(PL_N, density=pl.nnz / PL_N ** 2, dtype=np.float32, seed=3)
    for name, a in () if slab_only else (("power_law", pl), ("random_uniform", ru)):
        p = ct.poh_plan(a, device=dev)
        per = torch.diff(p.panel_ptr).cpu().numpy()
        pieces = getattr(p, "spmm_pieces", None)
        print(f"[probe] {name}: nnz {a.nnz}, {p.ntiles} tiles, {p.n_panels} panels, tiles per "
              f"panel max {per.max()} mean {per.mean():.1f}, fill {p.fill():.3f}, spmm pieces "
              f"{'none' if pieces is None else pieces.shape[0]}", flush=True)
        for k in (4, 32):
            X = torch.randn((PL_N, k), generator=gen, device=dev)
            print(f"[probe] poh_spmm {name} k={k}: {_ms(lambda: poh_spmm(p, X)) * 1e3:.1f} us",
                  flush=True)
        i = int(per.argmax())
        one = _one_panel(p, i)
        X = torch.randn((PL_N, 32), generator=gen, device=dev)
        print(f"[probe] poh_spmm {name} k=32, heaviest panel {i} alone ({per[i]} tiles): "
              f"{_ms(lambda: poh_spmm(one, X)) * 1e3:.1f} us", flush=True)
        if pieces is not None:
            for vname, fn in variants.items():
                def call(fn=fn):
                    Y = torch.zeros((PL_N, 32), device=dev)
                    err = fn(p.vals.data_ptr(), p.cloc.data_ptr(), p.rloc.data_ptr(),
                             p.wlo.data_ptr(), pieces.data_ptr(), X.data_ptr(), Y.data_ptr(),
                             pieces.shape[0], p.row_panel, p.col_window, p.slot_rows * 128, PL_N,
                             PL_N, 32, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant '{vname}': CUDA error {err}")
                print(f"[probe] poh_spmm {name} k=32, variant '{vname}' (Y zeroed per call): "
                      f"{_ms(call) * 1e3:.1f} us", flush=True)
        del p, one, X

    torch.backends.cuda.matmul.allow_tf32 = False
    for dt in (torch.float32,) if slab_only else (torch.float32, torch.float64):
        a = fem_blocks(512, dof=4, dtype=np.float32 if dt == torch.float32 else np.float64,
                       seed=0, return_bsr=True)
        sl = slab_auto_plan(ct.bdia_plan(a, device=dev))
        X = torch.randn((a.shape[1], 128), generator=gen, device=dev, dtype=dt)
        print(f"[probe] bdia_spmm_slab {str(dt)[6:]} k=128 (g {sl.g}, W {sl.width}): "
              f"{_ms(lambda: bdia_spmm_slab(sl, X)) * 1e3:.1f} us", flush=True)
        if dt == torch.float32:
            S = _sparse_csr(a, dev)
            print(f"[probe] cuSPARSE (torch.sparse_csr_tensor @ X) float32 k=128: "
                  f"{_ms(lambda: S @ X) * 1e3:.1f} us", flush=True)
            del S
            cases = _error_cases(dev)
            load = build.load  # the wrapper pointed at each variant's library in turn
            try:
                for vname, so in slab_variants.items():
                    build.load = lambda name, so=so: ctypes.CDLL(str(so))
                    bsk._lib.cache_clear()
                    errs = "" if vname in ("no products", "no copies") else \
                        "; error vs f64 " + ", ".join(_slab_error(c, sl_c, x_c)
                                                      for c, sl_c, x_c in cases)
                    print(f"[probe] bdia_spmm_slab float32 k=128, variant '{vname}': "
                          f"{_ms(lambda: bdia_spmm_slab(sl, X)) * 1e3:.1f} us{errs}", flush=True)
            finally:
                build.load = load
                bsk._lib.cache_clear()
        del sl, X
    if not slab_only:
        print(f"[probe] mma.sync m16n8k8 TF32 alone: {_mma_peak():.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
