// Fused segment scan for NVIDIA Hopper (sm_90a): bit-unpack -> filter ->
// group keys -> aggregate, in one pass over a batch of S segments' staged
// columns (one segment is the batch S = 1).
//
// Replaces the TPU kernel pinot_tpu/engine/pallas_kernels.py:603
// build_kernel (pl.pallas_call at :866, grid (S, T)), in both of its modes:
// the full aggregation and the group-range probe (masked min/max of group
// dictIds). Launched once over a whole segment batch it also replaces the
// sharded wrappers pinot_tpu/parallel/combine.py:298
// build_sharded_pallas_kernel and :360 build_sharded_pallas_probe on one
// card: the batch's segments share unified dictionaries, hence one group
// key space, so every tile adds into the same [rows, G] outputs (the
// in-kernel counterpart of the mesh psum/pmin/pmax over the seg axis) and
// only the matched-doc counts stay per segment ([S]).
//
// The TPU kernel is specialised per plan by tracing; this one is built once
// and interprets a small postfix program the host compiles from the plan
// (pinot_tpu_torch/engine/fused_scan.py compile_program):
//   - the filter as ops over IV(col, slot), IVS(col, slot0, n), TRUE, AND,
//     OR, NOT on dictIds, ANDed with doc < num_docs of its segment;
//   - value expressions as ops over COL, ID, LITC, LITF, TIMES, PLUS,
//     MINUS, each int (exact in i64) or float (f32, IEEE round-to-nearest);
//   - a list of accumulator rows: int sums in i64, float sums in f64,
//     min/max in f32, plus the implicit per-group count in i64.
// Layout: docs come in tiles of 4096, T tiles per segment; packed columns
// are [S, T, W], value columns [S, T * 4096] (a dictionary column's decoded
// values or a raw column's own: i32, i64 or f32), and num_docs [S] masks
// each segment's tail. A plan may read no packed column (no filter, no
// group key: a TRUE filter over value columns alone). A B-bit column (B a
// power of two) packs 32/B values per word, W = 128 * B words per tile
// (512 * B bytes), value j of a tile in word j & (W - 1) at bit
// (j >> log2 W) * B. Tile t belongs to segment t / T and holds that
// segment's docs (t % T) * 4096 + j.
//
// Bound: the least time is the bytes the scan must read over 3.35 TB/s,
// and those depend on the data: the filter's packed columns for every doc,
// but group-key columns and values only in the 32-byte sectors that hold a
// doc passing the filter (chip_smoke.py _needed_bytes counts exactly
// that). SSB's filters pass 0.1-3% of docs, so most of those bytes are the
// filter's columns.
//
// Design, and what it does about each cost of a per-doc interpreter (the
// H100 timings that decided each choice are in PERF.md, PR 3):
//   - Persistent grid. The launcher sizes the grid with the occupancy API
//     (blocks per SM for this shared-memory size x SMs, at most one block
//     per tile); block b walks tiles b, b + grid, ..., so the program load,
//     the accumulator initialisation and the flush are paid once per block
//     over many tiles. 60 registers give 4 blocks of 256 threads per SM.
//   - The filter is interpreted once per thread per tile, not per doc.
//     Thread i holds docs i + 256 r, r = 0..15; every filter op yields a
//     16-bit mask of them; AND, OR, NOT are bitwise; the stack's top is a
//     register, the levels below it live in shared memory [depth][BLOCK].
//     An IV/IVS leaf reads the thread's B/2 words of the column (one for
//     B <= 2; the host passes log2 B, so there is no division) and tests
//     every field of a word at once up to 8 bits (SWAR: even and odd
//     fields as 2B-bit lanes with a guard bit, two subtractions and an
//     AND), then moves the result bits into the mask with a few shifts;
//     16- and 32-bit fields are compared one by one. The filter's
//     instructions are the likely bound on SSB, not its loads: of the
//     variants timed (PERF.md, PR 3) none that changed how the columns
//     arrive made it faster.
//   - Filter columns ("early": read by an IV/IVS op) are read straight from
//     device memory through the read-only path: at 32 warps per SM these
//     loads keep enough bytes in flight. A ring of shared memory filled
//     per tile by 1D bulk copies (cp.async.bulk, an mbarrier per stage),
//     the counterpart of the Pallas BlockSpec double buffer, took 0.99 to
//     1.31x the time of these loads on the H100 and was removed.
//   - Group-key ("late") columns and values are read only for passing docs.
//     Each warp compacts its passing docs into a list in shared memory, so
//     every lane takes about one doc rather than its own uneven share, and
//     a doc's operands (group keys, ID values, value columns; up to
//     MAX_OPND) are loaded together through the read-only path before the
//     program runs: one memory latency per doc, not one per operand.
//   - No local memory: no array is indexed by a runtime value. Operands are
//     picked from registers by a chain of selects; the value stack keeps
//     its top in registers and the levels below in shared memory
//     [depth][BLOCK]; a scalar scan folds each row into per-thread slots in
//     shared memory [rows][BLOCK], reduced across the warp with shuffles at
//     the end into one global atomic per warp and row; the tile loop keeps
//     its counters in 32 bits and recomputes shared-memory pointers where
//     it uses them.
//   - Grouped scans add into block-private shared accumulators while they
//     fit beside two blocks on an SM, flushed with one global atomic per
//     touched group and row; past that the block adds straight into global
//     memory (one block of 8 warps per SM is slower than L2 atomics at 4).
//   - Tensor cores are not used: the scan moves bytes and does a few
//     integer operations per doc, and only the passing docs (about 1-2% on
//     SSB) add into accumulators. The TPU kernel's one-hot matmul
//     (pallas_kernels.py:785-792) stands in for scatter atomics, which the
//     TPU lacks and this card has.
// Matched-doc counts (popcounts of the masks) are reduced per warp and
// flushed to out_matched[s] whenever a block's next tile lies in another
// segment, and at the end. Outputs are zeroed or set to +-inf by the
// caller; the kernel allocates nothing and runs on the caller's stream.
//
// Query axis (fused_scan_many_kernel): one launch serves Q programs of one
// layout over the same batch, the counterpart of jax.vmap over the sharded
// Pallas calls (pinot_tpu/parallel/combine.py:298 and :360 under
// pinot_tpu/parallel/launcher.py:92 run_many): concurrent same-shape
// queries, a dashboard's traffic. Programs of one layout
// (fused_scan.py ScanProgram.layout_key) differ only in interval bounds,
// LITC / LITF literals and group-key strides: the filter ops, their
// columns and IVS run counts, the value ops, the operands, the rows, G and
// the key offset are the same in all of them. The programs are stacked
// [Q, prog_len]; each query's outputs lie out_qstride bytes after the
// previous query's.
//
// Bound: the bytes of one scan, each read once for all Q programs (a late
// column's sectors where a doc passes any program), plus each program's
// outputs, over 3.35 TB/s; then the filter arithmetic, which grows with Q,
// and the passing docs' operand loads and atomics. Launching the
// one-query design Q times over (block (x, y) walking every tile for
// query y) loaded each filter word Q times, interpreted the filter Q
// times and loaded a doc's operands once per program that it passed.
// Here:
//   - A block serves a group of up to QG = 8 programs (grid y is the
//     group); grid x is the persistent grid for this kernel's shared
//     memory, and block x walks tiles x, x + grid, ... once for the whole
//     group.
//   - Each filter op is fetched and decoded once per tile and thread for
//     the group: an IV/IVS leaf loads the thread's words of the column
//     once, then runs the SWAR tests (leaf_fields, compacted once a
//     program by leaf_bits) against each program's intervals. The group's
//     16-doc masks are packed in four registers (program q, doc r at bit
//     16 q + r), so AND, OR and NOT stay bitwise; the stack's levels below
//     the top live in shared memory [depth][BLOCK] at 16 bytes an entry.
//   - Where those tests would cost more than decoding each doc once (a 4-
//     or 8-bit column, enough programs or intervals: lut_leaf), the block
//     first builds the leaf's table, one 16-byte entry a dictId holding
//     the group's mask bits of that value; a doc's field then takes one
//     shared-memory lookup and four shift-ORs, whatever the number of
//     programs.
//   - Each warp compacts the union of the group's passing docs into one
//     list, each entry the doc and its QG-bit membership; a doc's operands
//     are loaded once (load_operands), then every program it passed
//     computes its key with its strides and its expressions with its
//     literals, and adds into its own accumulators.
//   - Grouped scans keep one set of block-private shared accumulators a
//     program while the group's sets fit beside two blocks on an SM, and
//     add into device memory past that; scalar scans keep per-thread slots
//     [QG][rows][BLOCK] (u64 sums, f32 min/max); matched docs are counted
//     per program and segment (a scalar program's count row is its
//     matched docs).
//   - The group size shrinks below QG only where QG programs' scalar slots
//     or accumulators would not fit in a block (fused_scan.py
//     query_group).
// Tried on the H100 and not kept, as neither was faster: an L2 prefetch of
// the next tile's filter words, and staging the previous tile's operands
// with cp.async while the next tile's filter runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#define MAX_COLS 16
#define TILE 4096
#define BLOCK 256
#define DOCS_PER_THREAD (TILE / BLOCK)
#define SMEM_BLOCK_MAX (227 * 1024)
#define MAX_OPND 8
#define QG 8           // programs a block of the query axis serves
// a query-axis leaf over 4- or 8-bit dictIds takes a table (lut_leaf) when
// its group's SWAR tests would cost more instructions a thread and tile
// than the table's LUT_COST; at most MAX_LUTS tables a block
#define LUT_COST 176
#define MAX_LUTS 8

enum { F_TRUE = 0, F_IV = 1, F_IVS = 2, F_AND = 3, F_OR = 4, F_NOT = 5 };
enum { V_COL = 0, V_ID = 1, V_LITC = 2, V_LITF = 3, V_TIMES = 4, V_PLUS = 5,
       V_MINUS = 6 };
enum { R_ISUM = 1, R_FSUM = 2, R_MIN = 3, R_MAX = 4 };
enum { T_F32 = 0, T_I32 = 1, T_I64 = 2 };

// argv slots (fused_scan.py _A_*)
enum {
  A_NUM_DOCS = 0, A_NUM_TILES, A_SEG_TILES, A_G, A_N_PACKED, A_N_VALUES,
  A_PROG, A_PROG_LEN, A_FILTER_OFF, A_FILTER_N, A_VOPS_OFF, A_EXPR_OFF,
  A_ROWS_OFF, A_N_ROWS, A_GROUP_OFF, A_N_GROUP, A_IV_OFF, A_KEY_OFFSET,
  A_N_ISUM, A_N_FSUM, A_N_MM, A_SCALAR, A_ACC_SMEM, A_OUT_CNT, A_OUT_ISUM,
  A_OUT_FSUM, A_OUT_MM, A_OUT_MATCHED, A_SMEM, A_PROG_SMEM_OFF,
  A_MSTACK_OFF, A_VSTACK_OFF, A_ACC_OFF, A_RACC_OFF, A_WLIST_OFF, A_N_OPND,
  A_Q, A_OUT_QSTRIDE, A_QG, A_ACC_QSTRIDE, A_LUT_OFF, A_LUT_BYTES,
  A_PACKED = 48, A_LOG2_BITS = 64, A_VALUES = 80, A_VTYPES = 96,
  A_SLOT_PACKED = 112, A_SLOT_VALUE = 128, A_LEN = 144
};

typedef unsigned long long u64;

struct ScanArgs {
  const uint32_t* packed[MAX_COLS];
  int lb[MAX_COLS];             // log2 of each packed column's bit width
  const void* values[MAX_COLS];
  int vtype[MAX_COLS];
  const int* prog;
  int prog_len, n_packed, n_values;
  int filter_off, filter_n, vops_off, expr_off, rows_off, n_rows;
  int group_off, n_group, iv_off;
  long long key_offset;
  const long long* num_docs;    // [S] docs of each segment
  long long num_tiles;          // S * T tiles in the batch
  long long seg_tiles;          // T tiles per segment
  int G, n_isum, n_fsum, n_mm, scalar, acc_in_smem;
  int prog_smem_off, mstack_off, vstack_off, acc_off, racc_off, wlist_off;
  // a passing doc's operands: operand k is packed column opnd_col[k]'s
  // dictId (opnd_packed[k]) or that value column's value; slot_packed[c]
  // and slot_value[c] are a column's operand, -1 when it has none
  int n_opnd;
  int opnd_col[MAX_OPND], opnd_packed[MAX_OPND];
  int slot_packed[MAX_COLS], slot_value[MAX_COLS];
  u64* out_cnt;
  u64* out_isum;
  double* out_fsum;
  float* out_mm;
  u64* out_matched;             // [S] docs passing the filter, per segment
  // the query axis: Q programs stacked [Q, prog_len], up to qg of them a
  // block; query n's outputs at out_qstride * n bytes, a block's program
  // q's shared accumulators at acc_qstride * q bytes past acc_off
  int q_total, qg;
  long long out_qstride, acc_qstride;
  // 32-bit words from one min/max scalar slot to the next: 2 in the
  // one-query layout (every row a u64), 1 on the query axis
  int mm_words;
  int lut_off, lut_bytes;       // the query axis's leaf tables
};

// query n's copy of an output (n = 0 outside the query axis)
template <class T>
__device__ __forceinline__ T* qout(T* p, const ScanArgs& a, int n) {
  return (T*)((char*)p + (size_t)n * a.out_qstride);
}

// ---- packed dictIds ---------------------------------------------------------

// SWAR constants of B-bit fields (B = 1 << LB <= 8) seen as 2B-bit lanes
// of even (or odd) fields: ONE bit 0 of every lane, EV its low B bits, G its
// guard bit B
template <int LB>
struct Swar {
  static constexpr int B = 1 << LB;
  static constexpr uint32_t ONE = LB == 0 ? 0x55555555u
                                : LB == 1 ? 0x11111111u
                                : LB == 2 ? 0x01010101u : 0x00010001u;
  static constexpr uint32_t EV = ONE * ((1u << B) - 1u);
  static constexpr uint32_t G = ONE << B;
};

// lo <= field <= hi for all 32/B fields of w at once, as bit f * B for field
// f; lor = lo * ONE, hig = hi * ONE | G with 0 <= lo <= hi < 2^B, so no lane
// borrows from the next
template <int LB>
__device__ __forceinline__ uint32_t fields_in(uint32_t w, uint32_t lor,
                                              uint32_t hig) {
  using S = Swar<LB>;
  const uint32_t e = w & S::EV, o = (w >> S::B) & S::EV;
  const uint32_t ie = ((e | S::G) - lor) & (hig - e) & S::G;
  const uint32_t io = ((o | S::G) - lor) & (hig - o) & S::G;
  return (ie >> S::B) | io;
}

// bit 2 f -> bit f, for f < 16
__device__ __forceinline__ uint32_t compress_even(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

// bit f * B -> bit f * B / 2
template <int LB>
__device__ __forceinline__ uint32_t halve(uint32_t x) {
  if constexpr (LB == 1) {
    return compress_even(x);
  } else if constexpr (LB == 2) {
    x = (x | (x >> 2)) & 0x05050505u;
    x = (x | (x >> 4)) & 0x00550055u;
    return (x | (x >> 8)) & 0x00005555u;
  } else {
    x = (x | (x >> 4)) & 0x00110011u;
    return (x | (x >> 8)) & 0x00001111u;
  }
}

// words a thread reads of one tile of a 2^LB-bit column
template <int LB>
struct Leaf {
  static constexpr int NW = LB == 0 ? 1 : (1 << LB) / 2;
};

// Thread i's words of the tile `p` of a 2^LB-bit column: doc i + 256 r
// sits in word i + 256 (r % (B/2)), field r / (B/2) for LB >= 1; in word
// i & 127, field (i >> 7) + 2 r for LB = 0.
template <int LB>
__device__ __forceinline__ void leaf_load(const uint32_t* p, int i,
                                          uint32_t (&w)[Leaf<LB>::NW]) {
  if constexpr (LB == 0) {
    w[0] = __ldg(p + (i & 127));
  } else {
#pragma unroll
    for (int k = 0; k < Leaf<LB>::NW; ++k) w[k] = __ldg(p + i + BLOCK * k);
  }
}

// 1 <= LB <= 3: bit f * B of acc[k] when field f of w[k] lies in any of
// the n intervals iv[2 s], iv[2 s + 1] (SWAR, every field of a word at
// once)
template <int LB>
__device__ __forceinline__ void leaf_fields(
    const uint32_t (&w)[Leaf<LB>::NW], const int* iv, int n,
    uint32_t (&acc)[Leaf<LB>::NW]) {
  constexpr int NW = Leaf<LB>::NW;
  constexpr uint32_t M = (1u << (1 << LB)) - 1u;
#pragma unroll
  for (int k = 0; k < NW; ++k) acc[k] = 0;
  for (int s = 0; s < n; ++s) {
    const int lo = max(iv[2 * s], 0);
    if (iv[2 * s + 1] < lo || (uint32_t)lo > M) continue;
    const uint32_t hi = min((uint32_t)iv[2 * s + 1], M);
    const uint32_t lor = lo * Swar<LB>::ONE;
    const uint32_t hig = hi * Swar<LB>::ONE | Swar<LB>::G;
#pragma unroll
    for (int k = 0; k < NW; ++k) acc[k] |= fields_in<LB>(w[k], lor, hig);
  }
}

// The 16-bit mask of thread i's docs (i + 256 r, bit r) whose dictId, in
// the words leaf_load read, lies in any of the n intervals iv[2 s],
// iv[2 s + 1]. Up to 8 bits, every field of a word is tested at once
// (fields_in); 16- and 32-bit fields one by one.
template <int LB>
__device__ __forceinline__ uint32_t leaf_test(
    const uint32_t (&w)[Leaf<LB>::NW], int i, const int* iv, int n) {
  constexpr int B = 1 << LB;
  constexpr uint32_t M = B == 32 ? 0xffffffffu : ((1u << (B & 31)) - 1u);
  if constexpr (LB == 0) {
    uint32_t r = 0;
    for (int s = 0; s < n; ++s) {
      const int lo = max(iv[2 * s], 0);
      if (iv[2 * s + 1] < lo || (uint32_t)lo > M) continue;
      const uint32_t hi = min((uint32_t)iv[2 * s + 1], M);
      r |= fields_in<0>(w[0], lo * Swar<0>::ONE,
                        hi * Swar<0>::ONE | Swar<0>::G);
    }
    return compress_even(r >> (i >> 7));
  } else {
    constexpr int NW = B / 2;
    uint32_t m = 0;
    if constexpr (LB <= 3) {
      uint32_t acc[NW];
      leaf_fields<LB>(w, iv, n, acc);
#pragma unroll
      for (int k = 0; k < NW; ++k) m |= halve<LB>(acc[k]) << k;
    } else {
      for (int s = 0; s < n; ++s) {
        const int lo = max(iv[2 * s], 0);
        const int hi = iv[2 * s + 1];
        if (hi < lo) continue;
        const uint32_t span = (uint32_t)(hi - lo);
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          if constexpr (LB == 4) {
            m |= (uint32_t)((w[k] & 0xffffu) - (uint32_t)lo <= span) << k;
            m |= (uint32_t)((w[k] >> 16) - (uint32_t)lo <= span) << (k + 8);
          } else {
            m |= (uint32_t)(w[k] - (uint32_t)lo <= span) << k;
          }
        }
      }
    }
    return m;
  }
}

// the 16-bit mask of thread i's docs of the tile `p` in any interval
template <int LB>
__device__ __forceinline__ uint32_t leaf_mask(const uint32_t* p, int i,
                                              const int* iv, int n) {
  uint32_t w[Leaf<LB>::NW];
  leaf_load<LB>(p, i, w);
  return leaf_test<LB>(w, i, iv, n);
}

__device__ __forceinline__ uint32_t leaf_any(int lb, const uint32_t* p, int i,
                                             const int* iv, int n) {
  switch (lb) {
    case 0: return leaf_mask<0>(p, i, iv, n);
    case 1: return leaf_mask<1>(p, i, iv, n);
    case 2: return leaf_mask<2>(p, i, iv, n);
    case 3: return leaf_mask<3>(p, i, iv, n);
    case 4: return leaf_mask<4>(p, i, iv, n);
    default: return leaf_mask<5>(p, i, iv, n);
  }
}

// ---- filter: one 16-bit doc mask per op --------------------------------------

__device__ __forceinline__ uint32_t eval_filter(
    const ScanArgs& a, const int* P, unsigned char* smem, long long tile) {
  const int i = threadIdx.x;
  unsigned short* mstk = (unsigned short*)(smem + a.mstack_off) + i;
  uint32_t top = 0;
  int sp = 0;  // entries: sp - 1 of them in mstk, the top in `top`
  for (int k = 0; k < a.filter_n; ++k) {
    const int* op = P + a.filter_off + 4 * k;
    const int o = op[0];
    if (o == F_NOT) {
      top = ~top & 0xffffu;
      continue;
    }
    if (o == F_AND || o == F_OR) {
      const uint32_t x = mstk[(sp - 2) * BLOCK];
      top = o == F_AND ? (x & top) : (x | top);
      --sp;
      continue;
    }
    uint32_t r = 0xffffu;
    if (o != F_TRUE) {
      const int c = op[1];
      const int* iv = P + a.iv_off + 2 * op[2];
      const int n = o == F_IV ? 1 : op[3];
      r = leaf_any(a.lb[c], a.packed[c] + tile * (128LL << a.lb[c]), i, iv,
                   n);
    }
    if (sp > 0) mstk[(sp - 1) * BLOCK] = (unsigned short)top;
    top = r;
    ++sp;
  }
  return top;
}

// ---- the query axis's filter: a group's masks per op -----------------------

// The masks of a group of up to QG programs: program q's 16-bit doc mask
// at bits 16 (q & 1) of w[q >> 1].
struct Mask4 {
  uint32_t w[QG / 2];
};
static_assert(QG == 8, "a group's masks are four 32-bit words");

// the bits of w[k] that belong to the group's nq programs
__device__ __forceinline__ uint32_t active_bits(int k, int nq) {
  return (2 * k < nq ? 0xffffu : 0u) | (2 * k + 1 < nq ? 0xffff0000u : 0u);
}

// leaf_test of one program for the query axis: for 4- and 8-bit fields
// the SWAR results of the thread's words are interleaved and compacted
// once (doc r = f * NW + k at bit f * B + k, then every B-bit group's low
// NW bits packed), not halved word by word
template <int LB>
__device__ __forceinline__ uint32_t leaf_bits(
    const uint32_t (&w)[Leaf<LB>::NW], int i, const int* iv, int n) {
  if constexpr (LB == 2 || LB == 3) {
    uint32_t acc[Leaf<LB>::NW];
    leaf_fields<LB>(w, iv, n, acc);
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < Leaf<LB>::NW; ++k) x |= acc[k] << k;
    if constexpr (LB == 2) x = (x | (x >> 2)) & 0x0f0f0f0fu;
    x = (x | (x >> 4)) & 0x00ff00ffu;
    return (x | (x >> 8)) & 0x0000ffffu;
  } else {
    return leaf_test<LB>(w, i, iv, n);
  }
}

// One IV/IVS leaf for the group: the thread's words of the column loaded
// once, then each program's intervals (at P + q * plen + ivo) tested
// against them, two programs at a time into their word of the masks,
// picked by selects (no array is indexed by the runtime q; a loop fully
// unrolled over the QG programs was slower on the H100).
template <int LB>
__device__ __forceinline__ Mask4 leaf_many(const uint32_t* p, int i,
                                           const int* P, int plen, int ivo,
                                           int n, int nq) {
  uint32_t w[Leaf<LB>::NW];
  leaf_load<LB>(p, i, w);
  Mask4 m;
#pragma unroll
  for (int k = 0; k < QG / 2; ++k) m.w[k] = 0;
  for (int q = 0; q < nq; q += 2) {
    uint32_t x = leaf_bits<LB>(w, i, P + q * plen + ivo, n);
    if (q + 1 < nq)
      x |= leaf_bits<LB>(w, i, P + (q + 1) * plen + ivo, n) << 16;
#pragma unroll
    for (int k = 0; k < QG / 2; ++k) m.w[k] = (q >> 1) == k ? x : m.w[k];
  }
  return m;
}

__device__ __forceinline__ Mask4 leaf_any_many(int lb, const uint32_t* p,
                                               int i, const int* P, int plen,
                                               int ivo, int n, int nq) {
  switch (lb) {
    case 0: return leaf_many<0>(p, i, P, plen, ivo, n, nq);
    case 1: return leaf_many<1>(p, i, P, plen, ivo, n, nq);
    case 2: return leaf_many<2>(p, i, P, plen, ivo, n, nq);
    case 3: return leaf_many<3>(p, i, P, plen, ivo, n, nq);
    case 4: return leaf_many<4>(p, i, P, plen, ivo, n, nq);
    default: return leaf_many<5>(p, i, P, plen, ivo, n, nq);
  }
}

// whether a leaf of n intervals over 2^LB-bit dictIds takes a table: the
// SWAR tests cost about 32 (LB = 2) or 60 (LB = 3) instructions a program
// and interval, a thread and tile (leaf_bits). Narrower columns never
// have the runs that would pay for one.
__device__ __forceinline__ bool lut_leaf(int lb, int n, int qg) {
  return (lb == 2 || lb == 3) && qg * n * (lb == 2 ? 32 : 60) > LUT_COST;
}

// Walks the filter's leaves in order, as the tables are laid out: the
// next leaf's table offset (bytes past lut_off), or -1 when it takes none.
struct LutCursor {
  int off = 0, count = 0;
  __device__ __forceinline__ int next(const ScanArgs& a, int lb, int n) {
    if (!lut_leaf(lb, n, a.qg) || count == MAX_LUTS) return -1;
    const int size = 16 << (1 << lb);
    if (off + size > a.lut_bytes) return -1;
    const int at = off;
    off += size;
    ++count;
    return at;
  }
};

// The leaf tables of the block's nq programs: entry d of a leaf's table is
// the group's masks of a doc whose dictId is d (word q >> 1, bit 16 (q &
// 1) set when d lies in one of program q's intervals). Called by every
// thread after the programs are in shared memory; the caller syncs.
__device__ __forceinline__ void build_luts(const ScanArgs& a, const int* P,
                                           unsigned char* smem, int nq) {
  LutCursor cur;
  for (int k = 0; k < a.filter_n; ++k) {
    const int* op = P + a.filter_off + 4 * k;
    if (op[0] != F_IV && op[0] != F_IVS) continue;
    const int lb = a.lb[op[1]], n = op[0] == F_IV ? 1 : op[3];
    const int at = cur.next(a, lb, n);
    if (at < 0) continue;
    uint4* T = (uint4*)(smem + a.lut_off + at);
    for (int d = threadIdx.x; d < (1 << (1 << lb)); d += BLOCK) {
      uint32_t w[QG / 2] = {0, 0, 0, 0};
      for (int q = 0; q < nq; ++q) {
        const int* iv = P + q * a.prog_len + a.iv_off + 2 * op[2];
        bool in = false;
        for (int s = 0; s < n; ++s)
          in |= iv[2 * s] <= d && d <= iv[2 * s + 1];
        const uint32_t bit = (uint32_t)in << (16 * (q & 1));
#pragma unroll
        for (int t = 0; t < QG / 2; ++t) w[t] |= (q >> 1) == t ? bit : 0u;
      }
      T[d] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// A leaf through its table: each of thread i's 16 docs decoded once, its
// table entry shifted into place (doc r at bit r of each word)
template <int LB>
__device__ __forceinline__ Mask4 leaf_lut(const uint32_t* p, int i,
                                          const uint4* T) {
  constexpr int NW = Leaf<LB>::NW, B = 1 << LB;
  uint32_t w[NW];
  leaf_load<LB>(p, i, w);
  Mask4 m;
#pragma unroll
  for (int k = 0; k < QG / 2; ++k) m.w[k] = 0;
#pragma unroll
  for (int r = 0; r < DOCS_PER_THREAD; ++r) {
    const uint4 t = T[(w[r % NW] >> ((r / NW) * B)) & ((1u << B) - 1u)];
    m.w[0] |= t.x << r;
    m.w[1] |= t.y << r;
    m.w[2] |= t.z << r;
    m.w[3] |= t.w << r;
  }
  return m;
}

// The filter of a group of nq programs (at P + q * prog_len, sharing
// every op), each op fetched and decoded once: the stack's top in
// registers, the levels below in shared memory [depth][BLOCK] as 16-byte
// entries.
__device__ __forceinline__ Mask4 eval_filter_many(
    const ScanArgs& a, const int* P, unsigned char* smem, long long tile,
    int nq) {
  const int i = threadIdx.x;
  uint4* mstk = (uint4*)(smem + a.mstack_off) + i;
  LutCursor cur;
  Mask4 top;
#pragma unroll
  for (int k = 0; k < QG / 2; ++k) top.w[k] = 0;
  int sp = 0;  // entries: sp - 1 of them in mstk, the top in `top`
  for (int k = 0; k < a.filter_n; ++k) {
    const int* op = P + a.filter_off + 4 * k;
    const int o = op[0];
    if (o == F_NOT) {
#pragma unroll
      for (int t = 0; t < QG / 2; ++t)
        top.w[t] = ~top.w[t] & active_bits(t, nq);
      continue;
    }
    if (o == F_AND || o == F_OR) {
      const uint4 x = mstk[(sp - 2) * BLOCK];
      const uint32_t xs[QG / 2] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int t = 0; t < QG / 2; ++t)
        top.w[t] = o == F_AND ? (xs[t] & top.w[t]) : (xs[t] | top.w[t]);
      --sp;
      continue;
    }
    Mask4 r;
    if (o == F_TRUE) {
#pragma unroll
      for (int t = 0; t < QG / 2; ++t) r.w[t] = active_bits(t, nq);
    } else {
      const int c = op[1], lb = a.lb[c], n = o == F_IV ? 1 : op[3];
      const uint32_t* p = a.packed[c] + tile * (128LL << lb);
      const int at = cur.next(a, lb, n);
      if (at >= 0) {
        const uint4* T = (const uint4*)(smem + a.lut_off + at);
        r = lb == 2 ? leaf_lut<2>(p, i, T) : leaf_lut<3>(p, i, T);
      } else {
        r = leaf_any_many(lb, p, i, P, a.prog_len, a.iv_off + 2 * op[2], n,
                          nq);
      }
    }
    if (sp > 0)
      mstk[(sp - 1) * BLOCK] =
          make_uint4(top.w[0], top.w[1], top.w[2], top.w[3]);
    top = r;
    ++sp;
  }
  return top;
}

// ---- operands and values ------------------------------------------------------

// A passing doc's operands (group-key dictIds, ID values, value columns),
// up to MAX_OPND of them, loaded together before the program runs: every
// load is in flight at once, then decoded. An operand past MAX_OPND is
// loaded where the program reads it.
__device__ __forceinline__ void load_operands(const ScanArgs& a,
                                              long long tile, int j,
                                              u64 (&o)[MAX_OPND]) {
  const long long doc = tile * TILE + j;  // in the batch's value columns
#pragma unroll
  for (int k = 0; k < MAX_OPND; ++k) {
    if (k >= a.n_opnd) break;
    const int c = a.opnd_col[k];
    if (a.opnd_packed[k]) {
      const int lb = a.lb[c];
      o[k] = __ldg(a.packed[c] + tile * (128LL << lb)
                   + (j & ((128 << lb) - 1)));
    } else if (a.vtype[c] == T_I64) {
      o[k] = (u64)__ldg((const long long*)a.values[c] + doc);
    } else {
      o[k] = __ldg((const uint32_t*)a.values[c] + doc);
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_OPND; ++k) {
    if (k >= a.n_opnd) break;
    const int c = a.opnd_col[k];
    if (a.opnd_packed[k]) {
      const int lb = a.lb[c];
      if (lb != 5)
        o[k] = ((uint32_t)o[k] >> ((j >> (7 + lb)) << lb))
               & ((1u << (1 << lb)) - 1u);
    } else if (a.vtype[c] == T_I32) {
      o[k] = (u64)(long long)(int)(uint32_t)o[k];
    }
  }
}

// operand k, by a chain of selects (no runtime index into an array)
__device__ __forceinline__ u64 pick(const u64 (&o)[MAX_OPND], int k) {
  u64 v = o[0];
#pragma unroll
  for (int i = 1; i < MAX_OPND; ++i) v = k == i ? o[i] : v;
  return v;
}

// dictId of doc j of `tile` in packed column c, from device memory
__device__ __forceinline__ u64 packed_operand(const ScanArgs& a,
                                              const u64 (&o)[MAX_OPND],
                                              int c, long long tile, int j) {
  const int k = a.slot_packed[c];
  if (k >= 0) return pick(o, k);
  const int lb = a.lb[c];
  const uint32_t w =
      __ldg(a.packed[c] + tile * (128LL << lb) + (j & ((128 << lb) - 1)));
  if (lb == 5) return w;
  return (w >> ((j >> (7 + lb)) << lb)) & ((1u << (1 << lb)) - 1u);
}

__device__ __forceinline__ float as_float(u64 bits, bool isf) {
  return isf ? __uint_as_float((uint32_t)bits) : (float)(long long)bits;
}

struct Val {
  u64 bits;    // i64, or the f32's bits
  bool isf;
};

__device__ __forceinline__ Val eval_expr(const ScanArgs& a, const int* P,
                                         int e, const u64 (&o)[MAX_OPND],
                                         long long tile, int j, u64* vstk) {
  u64 top = 0;
  bool tf = false;
  uint32_t fb = 0;  // float flags of the entries below the top
  int sp = 0;
  const int start = P[a.expr_off + 2 * e];
  const int n = P[a.expr_off + 2 * e + 1];
  for (int k = start; k < start + n; ++k) {
    const int* op = P + a.vops_off + 4 * k;
    const int code = op[0];
    if (code >= V_TIMES) {
      const u64 xb = vstk[(sp - 2) * BLOCK];
      const bool xf = (fb >> (sp - 2)) & 1u;
      if (op[3]) {
        const float x = as_float(xb, xf), y = as_float(top, tf);
        const float r = code == V_TIMES ? __fmul_rn(x, y)
                      : code == V_PLUS ? __fadd_rn(x, y) : __fsub_rn(x, y);
        top = __float_as_uint(r);
        tf = true;
      } else {
        const long long x = (long long)xb, y = (long long)top;
        top = (u64)(code == V_TIMES ? x * y : code == V_PLUS ? x + y : x - y);
        tf = false;
      }
      --sp;
      continue;
    }
    u64 r;
    switch (code) {
      case V_COL: {
        const int c = op[1];
        const int slot = a.slot_value[c];
        if (slot >= 0) {
          r = pick(o, slot);
        } else {
          const long long doc = tile * TILE + j;
          const int t = a.vtype[c];
          if (t == T_F32)
            r = __float_as_uint(__ldg((const float*)a.values[c] + doc));
          else if (t == T_I32)
            r = (u64)(long long)__ldg((const int*)a.values[c] + doc);
          else
            r = (u64)__ldg((const long long*)a.values[c] + doc);
        }
        break;
      }
      case V_ID:
        r = packed_operand(a, o, op[1], tile, j);
        break;
      case V_LITC:
        r = (u64)(long long)op[1];
        break;
      default:  // V_LITF
        r = (uint32_t)op[1];
    }
    if (sp > 0) {
      vstk[(sp - 1) * BLOCK] = top;
      fb = (fb & ~(1u << (sp - 1))) | ((uint32_t)tf << (sp - 1));
    }
    top = r;
    tf = op[3] != 0;
    ++sp;
  }
  return {top, tf};
}

// ---- reductions and atomics ----------------------------------------------------

// float min/max through the ordered-int encoding: non-negative floats order
// like signed ints, negative floats order inversely as unsigned ints
__device__ __forceinline__ void atomic_min_f(float* a, float v) {
  v = v + 0.0f;  // -0 -> +0
  if (v >= 0.0f) atomicMin((int*)a, __float_as_int(v));
  else atomicMax((unsigned int*)a, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f(float* a, float v) {
  v = v + 0.0f;
  if (v >= 0.0f) atomicMax((int*)a, __float_as_int(v));
  else atomicMin((unsigned int*)a, __float_as_uint(v));
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// called by every thread of the block at the same point (warp shuffles)
__device__ __forceinline__ void flush_matched(const ScanArgs& a, int seg,
                                              unsigned matched) {
  const long long m = warp_sum((long long)matched);
  if ((threadIdx.x & 31) == 0 && m && seg >= 0)
    atomicAdd(&a.out_matched[seg], (u64)m);
}

// a grouped scan's accumulators of the block's program q, query n: the
// block's own in shared memory, or the outputs (computed where they are
// used, so no pointer stays live in registers across the tile loop)
struct Acc {
  u64* cnt;
  u64* isum;
  double* fsum;
  float* mm;
};

__device__ __forceinline__ Acc accumulators(const ScanArgs& a,
                                            unsigned char* smem, int q,
                                            int n) {
  if (!a.acc_in_smem)
    return {qout(a.out_cnt, a, n), qout(a.out_isum, a, n),
            qout(a.out_fsum, a, n), qout(a.out_mm, a, n)};
  const size_t G = a.G;
  unsigned char* p = smem + a.acc_off + (size_t)q * a.acc_qstride;
  return {(u64*)p, (u64*)(p + G * 8), (double*)(p + G * 8 * (1 + a.n_isum)),
          (float*)(p + G * 8 * (1 + a.n_isum + a.n_fsum))};
}

// A scalar scan's per-thread slots: the rows come sums first (rows r <
// n_isum + n_fsum, u64 [qg][sums][BLOCK] at racc_off), then min/max (f32,
// mm_words words apart, [qg][n_mm][BLOCK] after the sums).
// Thread tid's slot of sum row r of the block's program q:
__device__ __forceinline__ u64* sum_slot(const ScanArgs& a,
                                         unsigned char* smem, int q, int r) {
  return (u64*)(smem + a.racc_off) + (q * (a.n_isum + a.n_fsum) + r) * BLOCK
         + threadIdx.x;
}

// and of min/max row r (r >= n_isum + n_fsum)
__device__ __forceinline__ float* mm_slot(const ScanArgs& a,
                                          unsigned char* smem, int q, int r) {
  const int n_sum = a.n_isum + a.n_fsum;
  return (float*)(smem + a.racc_off + (size_t)a.qg * n_sum * BLOCK * 8)
         + ((q * a.n_mm + r - n_sum) * BLOCK + threadIdx.x) * a.mm_words;
}

// Zero the accumulators of the block's nq programs (rows read from the
// programs in device memory: the shared copy is not yet visible), then,
// after a barrier, set the min/max rows to +-inf; ends with a barrier.
__device__ __forceinline__ void init_accumulators(const ScanArgs& a,
                                                  const int* prog,
                                                  unsigned char* smem,
                                                  int nq) {
  const int tid = threadIdx.x;
  const int G = a.G;
  if (a.acc_in_smem)
    for (int q = 0; q < nq; ++q) {
      const Acc acc = accumulators(a, smem, q, 0);
      for (int i = tid; i < G * (1 + a.n_isum); i += BLOCK) acc.cnt[i] = 0;
      for (int i = tid; i < G * a.n_fsum; i += BLOCK) acc.fsum[i] = 0.0;
    }
  if (a.scalar)
    for (int q = 0; q < nq; ++q)
      for (int r = 0; r < a.n_rows; ++r) {
        const int kind = prog[a.rows_off + 3 * r];
        if (kind == R_MIN || kind == R_MAX)
          *mm_slot(a, smem, q, r) = __int_as_float(
              kind == R_MIN ? 0x7f800000 : 0xff800000);
        else
          *sum_slot(a, smem, q, r) = 0ull;
      }
  __syncthreads();
  if (a.acc_in_smem)
    for (int q = 0; q < nq; ++q) {
      float* mm = accumulators(a, smem, q, 0).mm;
      for (int r = 0; r < a.n_rows; ++r) {
        const int* row = prog + a.rows_off + 3 * r;
        if (row[0] == R_MIN || row[0] == R_MAX) {
          const float init = row[0] == R_MIN ? __int_as_float(0x7f800000)
                                             : __int_as_float(0xff800000);
          for (int g = tid; g < G; g += BLOCK)
            mm[(size_t)row[2] * G + g] = init;
        }
      }
    }
  __syncthreads();
}

// One program's adds for a passing doc (j of `tile`) whose operands are
// loaded: P is the program (its strides and literals), q its place in the
// block's group, n its query. A scalar scan folds each row into this
// thread's slots in shared memory ([q][rows][BLOCK]); a grouped scan adds
// into its group.
__device__ __forceinline__ void add_doc(const ScanArgs& a, const int* P,
                                        unsigned char* smem, long long tile,
                                        int j, const u64 (&o)[MAX_OPND],
                                        int q, int n) {
  u64* vstk = (u64*)(smem + a.vstack_off) + threadIdx.x;
  if (a.scalar) {
    for (int r = 0; r < a.n_rows; ++r) {
      const int* row = P + a.rows_off + 3 * r;
      const Val v = eval_expr(a, P, row[1], o, tile, j, vstk);
      switch (row[0]) {
        case R_ISUM: *sum_slot(a, smem, q, r) += v.bits; break;
        case R_FSUM: {
          u64* slot = sum_slot(a, smem, q, r);
          *slot = __double_as_longlong(__longlong_as_double(*slot)
                                       + (double)as_float(v.bits, v.isf));
          break;
        }
        case R_MIN: {
          float* slot = mm_slot(a, smem, q, r);
          *slot = fminf(*slot, as_float(v.bits, v.isf));
          break;
        }
        default: {
          float* slot = mm_slot(a, smem, q, r);
          *slot = fmaxf(*slot, as_float(v.bits, v.isf));
        }
      }
    }
    return;
  }
  const int G = a.G;
  long long key = -a.key_offset;
  for (int g = 0; g < a.n_group; ++g)
    key += (long long)packed_operand(a, o, P[a.group_off + 2 * g], tile, j)
           * P[a.group_off + 2 * g + 1];
  if (key < 0 || key >= G) return;
  const Acc acc = accumulators(a, smem, q, n);
  atomicAdd(&acc.cnt[key], 1ull);
  for (int r = 0; r < a.n_rows; ++r) {
    const int* row = P + a.rows_off + 3 * r;
    const Val v = eval_expr(a, P, row[1], o, tile, j, vstk);
    const size_t at = (size_t)row[2] * G + key;
    switch (row[0]) {
      case R_ISUM: atomicAdd(&acc.isum[at], v.bits); break;
      case R_FSUM:
        atomicAdd(&acc.fsum[at], (double)as_float(v.bits, v.isf));
        break;
      case R_MIN: atomic_min_f(&acc.mm[at], as_float(v.bits, v.isf)); break;
      default: atomic_max_f(&acc.mm[at], as_float(v.bits, v.isf));
    }
  }
}

// A scalar scan's rows of the block's program q, reduced across the warp,
// added into query n's outputs by lane 0 where `add` and the warp's value
// is not the row's identity (0, +inf for min, -inf for max: adding it
// changes nothing). Every thread of the warp calls it (shuffles).
__device__ __forceinline__ void flush_rows(const ScanArgs& a, const int* P,
                                           unsigned char* smem, int q, int n,
                                           bool add) {
  for (int r = 0; r < a.n_rows; ++r) {
    const int* row = P + a.rows_off + 3 * r;
    const int o = row[2];
    switch (row[0]) {
      case R_ISUM: {
        const long long t = warp_sum((long long)*sum_slot(a, smem, q, r));
        if (add && t) atomicAdd(&qout(a.out_isum, a, n)[o], (u64)t);
        break;
      }
      case R_FSUM: {
        const double t = warp_sum(
            __longlong_as_double((long long)*sum_slot(a, smem, q, r)));
        if (add && t != 0.0) atomicAdd(&qout(a.out_fsum, a, n)[o], t);
        break;
      }
      case R_MIN: {
        const float t = warp_min(*mm_slot(a, smem, q, r));
        if (add && t != __int_as_float(0x7f800000))
          atomic_min_f(&qout(a.out_mm, a, n)[o], t);
        break;
      }
      default: {
        const float t = warp_max(*mm_slot(a, smem, q, r));
        if (add && t != __int_as_float(0xff800000))
          atomic_max_f(&qout(a.out_mm, a, n)[o], t);
      }
    }
  }
}

// A grouped scan's shared accumulators of the block's program q, added
// into query n's outputs: one global atomic per touched group and row.
__device__ __forceinline__ void flush_acc(const ScanArgs& a, const int* P,
                                          unsigned char* smem, int q, int n) {
  const int G = a.G;
  const Acc acc = accumulators(a, smem, q, n);
  for (int g = threadIdx.x; g < G; g += BLOCK) {
    const u64 c = acc.cnt[g];
    if (c == 0) continue;
    atomicAdd(&qout(a.out_cnt, a, n)[g], c);
    for (int r = 0; r < a.n_rows; ++r) {
      const int* row = P + a.rows_off + 3 * r;
      const size_t at = (size_t)row[2] * G + g;
      switch (row[0]) {
        case R_ISUM:
          atomicAdd(&qout(a.out_isum, a, n)[at], acc.isum[at]);
          break;
        case R_FSUM:
          atomicAdd(&qout(a.out_fsum, a, n)[at], acc.fsum[at]);
          break;
        case R_MIN:
          atomic_min_f(&qout(a.out_mm, a, n)[at], acc.mm[at]);
          break;
        default: atomic_max_f(&qout(a.out_mm, a, n)[at], acc.mm[at]);
      }
    }
  }
}

// 4 blocks of 256 threads per SM: up to 64 registers a thread, which the
// kernel needs to keep its loop state out of local memory
extern "C" __global__ void __launch_bounds__(BLOCK, 4)
fused_scan_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* P = (int*)(smem + a.prog_smem_off);
  for (int i = tid; i < a.prog_len; i += BLOCK) P[i] = a.prog[i];
  init_accumulators(a, a.prog, smem, 1);

  // the loop's state in 32 bits, so it stays in registers: the launcher
  // checks the tile count, a segment has fewer than 2^31 docs, and a thread
  // counts at most 16 docs a tile
  const unsigned num_tiles = (unsigned)a.num_tiles;
  const unsigned seg_tiles = (unsigned)a.seg_tiles;
  unsigned lcnt = 0, lmatched = 0;
  int seg = -1, seg_docs = 0;        // segment lmatched counts, its docs
  for (unsigned tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int s = (int)(tile / seg_tiles);
    if (s != seg) {
      flush_matched(a, seg, lmatched);
      lmatched = 0;
      seg = s;
      seg_docs = (int)a.num_docs[s];
    }
    // docs of this tile below the segment's num_docs, as a mask of r
    const int left = seg_docs - (int)(tile - s * seg_tiles) * TILE - tid;
    const int n_valid = left <= 0 ? 0
        : left >= (DOCS_PER_THREAD - 1) * BLOCK + 1
            ? DOCS_PER_THREAD : (left + BLOCK - 1) / BLOCK;
    const uint32_t valid = (1u << n_valid) - 1u;
    const uint32_t mask = valid ? eval_filter(a, P, smem, tile) & valid : 0;
    const int hits = __popc(mask);
    lmatched += hits;
    lcnt += hits;
    // the warp's passing docs, compacted into its list: each lane then
    // takes about one doc, not its own (uneven) share
    int incl = hits;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (total == 0) continue;
    unsigned short* wl = (unsigned short*)(smem + a.wlist_off) + warp * 512;
    int pos = incl - hits;
    for (uint32_t m = mask; m; m &= m - 1)
      wl[pos++] = (unsigned short)(tid + (__ffs(m) - 1) * BLOCK);
    __syncwarp();
    for (int k = lane; k < total; k += 32) {
      const int j = wl[k];
      u64 o[MAX_OPND] = {};
      load_operands(a, tile, j, o);
      add_doc(a, P, smem, tile, j, o, 0, 0);
    }
    __syncwarp();
  }

  flush_matched(a, seg, lmatched);
  if (a.scalar) {
    const long long cnt_w = warp_sum((long long)lcnt);
    if (lane == 0 && cnt_w) atomicAdd(&a.out_cnt[0], (u64)cnt_w);
    flush_rows(a, P, smem, 0, 0, lane == 0 && cnt_w);
    return;
  }
  if (!a.acc_in_smem) return;
  __syncthreads();
  flush_acc(a, P, smem, 0, 0);
}

// The query axis's matched docs of segment seg, per program of the group
// (queries q0 + q), added by lane 0; a scalar program's count row is its
// matched docs. Called by every thread of the block at the same point.
__device__ __forceinline__ void flush_matched_many(const ScanArgs& a, int seg,
                                                   const unsigned (&lm)[QG],
                                                   int q0, int nq) {
#pragma unroll
  for (int q = 0; q < QG; ++q) {
    if (q < nq) {
      const unsigned m = __reduce_add_sync(0xffffffffu, lm[q]);
      if ((threadIdx.x & 31) == 0 && m && seg >= 0) {
        atomicAdd(&qout(a.out_matched, a, q0 + q)[seg], (u64)m);
        if (a.scalar) atomicAdd(&qout(a.out_cnt, a, q0 + q)[0], (u64)m);
      }
    }
  }
}

// The query axis: block (x, y) serves the programs q0 = y * qg .. q0 + nq
// - 1 and walks tiles x, x + gridDim.x, ... once for all of them (see the
// note at the top). 2 blocks of 256 threads per SM: up to 128 registers a
// thread (at 64, for 4 blocks, ptxas spills).
extern "C" __global__ void __launch_bounds__(BLOCK, 2)
fused_scan_many_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (int)blockIdx.y * a.qg;
  const int nq = min(a.qg, a.q_total - q0);
  // program q of the group at P + q * prog_len
  int* P = (int*)(smem + a.prog_smem_off);
  const int* prog = a.prog + (size_t)q0 * a.prog_len;
  for (int i = tid; i < nq * a.prog_len; i += BLOCK) P[i] = prog[i];
  __syncthreads();
  build_luts(a, P, smem, nq);
  init_accumulators(a, prog, smem, nq);

  const unsigned num_tiles = (unsigned)a.num_tiles;
  const unsigned seg_tiles = (unsigned)a.seg_tiles;
  unsigned lm[QG];       // this thread's docs passing each program in seg
#pragma unroll
  for (int q = 0; q < QG; ++q) lm[q] = 0;
  int seg = -1, seg_docs = 0;
  for (unsigned tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int s = (int)(tile / seg_tiles);
    if (s != seg) {
      flush_matched_many(a, seg, lm, q0, nq);
#pragma unroll
      for (int q = 0; q < QG; ++q) lm[q] = 0;
      seg = s;
      seg_docs = (int)a.num_docs[s];
    }
    const int left = seg_docs - (int)(tile - s * seg_tiles) * TILE - tid;
    const int n_valid = left <= 0 ? 0
        : left >= (DOCS_PER_THREAD - 1) * BLOCK + 1
            ? DOCS_PER_THREAD : (left + BLOCK - 1) / BLOCK;
    const uint32_t valid = (1u << n_valid) - 1u;
    Mask4 m;
    if (valid) {
      m = eval_filter_many(a, P, smem, tile, nq);
#pragma unroll
      for (int k = 0; k < QG / 2; ++k) m.w[k] &= valid | valid << 16;
    } else {
#pragma unroll
      for (int k = 0; k < QG / 2; ++k) m.w[k] = 0;
    }
    // per-program counts (of the group's words only), and the union of
    // the group's passing docs
    uint32_t u = 0;
#pragma unroll
    for (int k = 0; k < QG / 2; ++k)
      if (2 * k < nq) {
        lm[2 * k] += __popc(m.w[k] & 0xffffu);
        lm[2 * k + 1] += __popc(m.w[k] >> 16);
        u |= m.w[k];
      }
    u = (u | (u >> 16)) & 0xffffu;
    const int hits = __popc(u);
    int incl = hits;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (total == 0) continue;
    // the warp's list: doc j (u16) and its programs (u8) at entry k
    unsigned short* wl = (unsigned short*)(smem + a.wlist_off) + warp * 512;
    unsigned char* wm = smem + a.wlist_off + 2 * TILE + warp * 512;
    int pos = incl - hits;
    for (uint32_t x = u; x; x &= x - 1) {
      const int r = __ffs(x) - 1;
      uint32_t mem = 0;
#pragma unroll
      for (int k = 0; k < QG / 2; ++k)
        if (2 * k < nq) {
          const uint32_t b = (m.w[k] >> r) & 0x10001u;
          mem |= (b & 1u) << (2 * k) | (b >> 16) << (2 * k + 1);
        }
      wl[pos] = (unsigned short)(tid + r * BLOCK);
      wm[pos++] = (unsigned char)mem;
    }
    __syncwarp();
    for (int k = lane; k < total; k += 32) {
      const int j = wl[k];
      u64 o[MAX_OPND] = {};
      load_operands(a, tile, j, o);
      for (uint32_t mem = wm[k]; mem; mem &= mem - 1) {
        const int q = __ffs(mem) - 1;
        add_doc(a, P + q * a.prog_len, smem, tile, j, o, q, q0 + q);
      }
    }
    __syncwarp();
  }

  flush_matched_many(a, seg, lm, q0, nq);
  if (a.scalar) {
    for (int q = 0; q < nq; ++q)
      flush_rows(a, P + q * a.prog_len, smem, q, q0 + q, lane == 0);
    return;
  }
  if (!a.acc_in_smem) return;
  __syncthreads();
  for (int q = 0; q < nq; ++q)
    flush_acc(a, P + q * a.prog_len, smem, q, q0 + q);
}

// blocks per SM x SMs of `kernel` for this shared-memory size on the
// current device, computed once per (kernel, device, size)
static int grid_for(const void* kernel, int smem, int* grid) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> cache;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(mu);
  auto it = cache.find({kernel, dev, smem});
  if (it != cache.end()) {
    *grid = it->second;
    return 0;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BLOCK_MAX);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cache[{kernel, dev, smem}] = *grid = per_sm * sms;
  return 0;
}

// argv (the A_* slots) -> ScanArgs and the shared-memory size; 0 or a
// CUDA error
static int parse_args(const long long* argv, ScanArgs& a, int* smem) {
  for (int c = 0; c < MAX_COLS; ++c) {
    a.packed[c] = (const uint32_t*)argv[A_PACKED + c];
    a.lb[c] = (int)argv[A_LOG2_BITS + c];
    a.values[c] = (const void*)argv[A_VALUES + c];
    a.vtype[c] = (int)argv[A_VTYPES + c];
  }
  a.prog = (const int*)argv[A_PROG];
  a.prog_len = (int)argv[A_PROG_LEN];
  a.n_packed = (int)argv[A_N_PACKED];
  a.n_values = (int)argv[A_N_VALUES];
  a.filter_off = (int)argv[A_FILTER_OFF];
  a.filter_n = (int)argv[A_FILTER_N];
  a.vops_off = (int)argv[A_VOPS_OFF];
  a.expr_off = (int)argv[A_EXPR_OFF];
  a.rows_off = (int)argv[A_ROWS_OFF];
  a.n_rows = (int)argv[A_N_ROWS];
  a.group_off = (int)argv[A_GROUP_OFF];
  a.n_group = (int)argv[A_N_GROUP];
  a.iv_off = (int)argv[A_IV_OFF];
  a.key_offset = argv[A_KEY_OFFSET];
  a.num_docs = (const long long*)argv[A_NUM_DOCS];
  a.num_tiles = argv[A_NUM_TILES];
  a.seg_tiles = argv[A_SEG_TILES];
  a.G = (int)argv[A_G];
  a.n_isum = (int)argv[A_N_ISUM];
  a.n_fsum = (int)argv[A_N_FSUM];
  a.n_mm = (int)argv[A_N_MM];
  a.scalar = (int)argv[A_SCALAR];
  a.acc_in_smem = (int)argv[A_ACC_SMEM];
  a.prog_smem_off = (int)argv[A_PROG_SMEM_OFF];
  a.mstack_off = (int)argv[A_MSTACK_OFF];
  a.vstack_off = (int)argv[A_VSTACK_OFF];
  a.acc_off = (int)argv[A_ACC_OFF];
  a.racc_off = (int)argv[A_RACC_OFF];
  a.wlist_off = (int)argv[A_WLIST_OFF];
  a.n_opnd = (int)argv[A_N_OPND];
  for (int k = 0; k < MAX_OPND; ++k) a.opnd_col[k] = a.opnd_packed[k] = 0;
  for (int c = 0; c < MAX_COLS; ++c) {
    a.slot_packed[c] = (int)argv[A_SLOT_PACKED + c];
    a.slot_value[c] = (int)argv[A_SLOT_VALUE + c];
    for (int packed = 0; packed < 2; ++packed) {
      const int k = packed ? a.slot_packed[c] : a.slot_value[c];
      if (k >= MAX_OPND || k >= a.n_opnd) return (int)cudaErrorInvalidValue;
      if (k >= 0) {
        a.opnd_col[k] = c;
        a.opnd_packed[k] = packed;
      }
    }
  }
  a.out_cnt = (u64*)argv[A_OUT_CNT];
  a.out_isum = (u64*)argv[A_OUT_ISUM];
  a.out_fsum = (double*)argv[A_OUT_FSUM];
  a.out_mm = (float*)argv[A_OUT_MM];
  a.out_matched = (u64*)argv[A_OUT_MATCHED];
  a.q_total = 1;
  a.qg = 1;
  a.out_qstride = 0;
  a.acc_qstride = 0;
  a.mm_words = 2;
  a.lut_off = a.lut_bytes = 0;
  for (int c = 0; c < a.n_packed && c < MAX_COLS; ++c)
    if (a.lb[c] < 0 || a.lb[c] > 5) return (int)cudaErrorInvalidValue;
  *smem = (int)argv[A_SMEM];
  if (a.n_packed > MAX_COLS || a.n_values > MAX_COLS || a.n_packed < 0
      || a.seg_tiles < 1 || a.num_tiles % a.seg_tiles != 0
      || a.num_tiles >= (1LL << 31) || a.seg_tiles * TILE >= (1LL << 31)
      || a.n_opnd < 0 || a.n_opnd > MAX_OPND || *smem > SMEM_BLOCK_MAX)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// one program: argv, the A_* slots (A_Q, A_QG, A_OUT_QSTRIDE and
// A_ACC_QSTRIDE are not read)
extern "C" int fused_scan_launch(const long long* argv, void* stream) {
  ScanArgs a;
  int smem = 0;
  int err = parse_args(argv, a, &smem);
  if (err != 0) return err;
  int grid = 0;
  err = grid_for((const void*)fused_scan_kernel, smem, &grid);
  if (err != 0) return err;
  if (grid > a.num_tiles) grid = (int)a.num_tiles;
  if (grid < 1) grid = 1;
  fused_scan_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the query axis: A_Q programs stacked [Q, prog_len] at A_PROG, A_QG of
// them a block, ceil(Q / QG) groups on grid y
extern "C" int fused_scan_many_launch(const long long* argv, void* stream) {
  ScanArgs a;
  int smem = 0;
  int err = parse_args(argv, a, &smem);
  if (err != 0) return err;
  const long long q = argv[A_Q], qg = argv[A_QG];
  a.out_qstride = argv[A_OUT_QSTRIDE];
  a.acc_qstride = argv[A_ACC_QSTRIDE];
  if (qg < 1 || qg > QG || q < 1 || (q + qg - 1) / qg > 65535
      || (q > 1 && a.out_qstride <= 0)
      || (qg > 1 && a.acc_in_smem && a.acc_qstride <= 0))
    return (int)cudaErrorInvalidValue;
  a.q_total = (int)q;
  a.qg = (int)qg;
  a.mm_words = 1;
  a.lut_off = (int)argv[A_LUT_OFF];
  a.lut_bytes = (int)argv[A_LUT_BYTES];
  if (a.lut_off < 0 || a.lut_bytes < 0 || a.lut_off + a.lut_bytes > smem)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  err = grid_for((const void*)fused_scan_many_kernel, smem, &grid);
  if (err != 0) return err;
  if (grid > a.num_tiles) grid = (int)a.num_tiles;
  if (grid < 1) grid = 1;
  fused_scan_many_kernel<<<dim3((unsigned int)grid,
                                (unsigned int)((q + qg - 1) / qg)),
                           BLOCK, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the grid x the launches take for `smem` bytes, before its cap at one
// block per tile: of fused_scan_kernel (many = 0) or fused_scan_many_kernel
extern "C" int fused_scan_grid(int smem, int many, int* grid) {
  return grid_for(many ? (const void*)fused_scan_many_kernel
                       : (const void*)fused_scan_kernel,
                  smem, grid);
}

extern "C" const char* fused_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
