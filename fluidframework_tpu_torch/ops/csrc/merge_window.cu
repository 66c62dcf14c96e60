// Hopper window kernel of the SharedString merge plane.
//
// Replaces the TPU kernel ops/pallas_merge.py::_kernel of the reference
// package (a doc-block grid that keeps the slot state in VMEM and runs
// merge_step.fused_step for every op of the window). It computes the
// same function as the plain torch loop ops/merge_step.py::fused_step
// over the window, bit for bit on int32, on every slot of [0, C).
//
// Bound on an H100 SXM at its published peaks (chip_smoke.py counts
// it): the state moves once in and once out per window plus 48 B per op
// (0.124 ms at 4096 x 1024 x 64); the integer work is 135 int32
// operations per slot per step, as counted on the plain version. Over
// the live slots of the real (non-NOOP) steps of chip_smoke.py's timed
// window, 0.48 of D*C*W, that is 1.04 ms on the INT32 lanes; over every
// slot of every step, as the plain version does it, 2.17 ms. The work
// is the larger bound. This design does only the live work: it touches
// only the slots below count, skips NOOP steps, and resolves the 12
// lookups as 3 first-true indices. Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700.00 W: 2.07 ms per launch at 4096 x 1024
// x 64 over runs of 10 launches, 0.50 of the 1.04 ms bound (the design
// before this one: 10.82 ms in the same call).
//
// What it does about the bound:
//  * one block of at most 256 threads per document; each thread owns a
//    contiguous run of 4*Q slots (Q = 1 up to C = 1024, the main path)
//    and moves each field of a quad of slots as one 16-byte vector;
//    up to 4 documents share an SM at C = 1024;
//  * the 12 slot fields live in dynamic shared memory ([12][C] int32)
//    when C <= 4096. At C > 4096 (8192 is the largest capacity the op_off
//    composite allows) a document is a thread block cluster of CLUSTER
//    CTAs (the cluster form below): each CTA keeps a contiguous span of
//    the slots in its own shared memory, and the CTAs meet over
//    distributed shared memory (DSMEM);
//  * only slots below ``count`` are viewed, scanned and restructured.
//    Slots at or above ``count`` never enter a view, and each step that
//    adds k slots shifts that garbage tail right by exactly k, so the
//    tail is written once at the end, copied from the input shifted by
//    the window's growth;
//  * one view pass per step, its visible lengths kept in registers:
//    serial sum per thread, warp shuffle scan, one barrier, the warp
//    totals read back;
//  * the 12 masked min-reduces of fused_step become 3 first-true
//    lookups. E, incl and the op_off composite j*2^17 + op_off are
//    non-decreasing in j on every table the merge plane holds (lengths
//    >= 0, visible total < 2^31, 0 <= op_off < 2^17), so each masked
//    minimum is the value at the first true slot. The first lane of the
//    first warp with a hit publishes (idx, E, incl, op_off); a second
//    barrier makes it visible;
//  * the two-insertion restructure runs in place: each thread captures
//    the two old slots before its run before the second barrier, then
//    rewrites its quads top down. Quads below the first changed slot
//    are left alone, or get only their stamped fields rewritten;
//  * a NOOP step only raises min_seq: no barrier, no pass over slots.
// Two __syncthreads per step, none on a NOOP step.
//
// The cluster form (C > 4096). Rank r of a document's cluster holds the
// slots [r*span,
// (r+1)*span), span = ceil(C / CLUSTER) rounded up to a whole number of
// warps' runs, so at C = 8192 and CLUSTER = 8 each CTA does the main
// instantiation's per-thread work (4 slots per thread, 256 threads, 48
// KiB of shared memory). The two barriers of a step become cluster
// barriers (barrier.cluster.arrive.release / wait.acquire), and what
// crosses a span goes through DSMEM, pushed before the barrier that
// publishes it:
//  * barrier 1: lane 31 of each warp stores its warp total into every
//    rank's [rank][warp] table; each warp then reads the table locally
//    for its offset and the document's total;
//  * barrier 2: the first hit lane of a warp stores its (idx, E, incl,
//    op_off) record into every rank and ORs its warp's bit into every
//    rank's 32-bit hit word of its own rank (one 64-bit mask that every
//    rank ORed into with generic atomics gave wrong lookups on an H100
//    when clusters ran crowded); the last thread of rank r pushes the
//    stamp bits of its last two slots to rank r + 1, whose thread 0
//    reads the two old slots before its span from rank r's shared memory
//    (rank r rewrites them only after barrier 2).
// A rank whose span no step of the window can reach (count grows by at
// most 2 a step) leaves at once, and the last rank that stays writes its
// part of the garbage tail; one that the window may reach does no slot
// work while its span lies at or above ``count`` but arrives at both
// barriers. The load and the final write are per span.
// One cluster barrier after the load (every rank's buffers zeroed before
// any rank writes into them) and one before the final write (no rank
// leaves while another may still touch its shared memory).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W:
// 3.25 ms at 512 x 8192 x 64, 0.30 of its 0.985 ms live bound (the
// design before: 14.78 ms beside it in tools/window_candidates.py), and
// 0.216 ms at the long-document pool's 16 x 8192 x 32 (2.52 ms).
//
// Integer semantics follow XLA's int32 (two's complement wrap): every
// addition or subtraction that can wrap goes through wadd / wsub in
// uint32, and removers are handled as uint32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int NPLAIN = 8;          // length..is_marker
constexpr int PROP_CHANNELS = 4;
constexpr int NFIELD = NPLAIN + PROP_CHANNELS;
constexpr int NOPS = 12;
constexpr int NLOOK = 3;           // insert target, split at p1, at p2
constexpr int BIG = 0x7fffffff;
constexpr int NOT_REMOVED = 0x7fffffff;
constexpr int OPOFF_BOUND = 1 << 17;
constexpr int KIND_INSERT = 0;
constexpr int KIND_REMOVE = 1;
constexpr int KIND_ANNOTATE = 2;
constexpr int THREADS = 256;       // most threads per document
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_CAPACITY = 8192;
constexpr int SMEM_MAX_CAPACITY = 4096;
// slots per thread are 4*Q, Q a power of two: the smallest that covers C
constexpr int SMEM_MAX_Q = SMEM_MAX_CAPACITY / (4 * THREADS);
// the main path's capacity, and the resident documents per SM asked of
// ptxas for its instantiation (the others: one)
constexpr int MAIN_CAPACITY = 1024;
constexpr int MAIN_Q = (MAIN_CAPACITY + 4 * THREADS - 1) / (4 * THREADS);
constexpr int MAIN_MIN_BLOCKS = 3;
// the cluster form: CTAs per document (8 is the portable most), the
// slots per thread that cover MAX_CAPACITY with them, and the CTAs per
// SM asked of ptxas (as many as the shared memory holds, at most 3)
constexpr int CLUSTER = 8;
constexpr int CLUSTER_Q = MAX_CAPACITY / (4 * THREADS * CLUSTER);
constexpr int CLUSTER_SMEM =
    (NFIELD * 4 * CLUSTER_Q + 1) * THREADS * 4 + 4096;
constexpr int CLUSTER_MIN_BLOCKS =
    232448 / CLUSTER_SMEM < 3 ? 232448 / CLUSTER_SMEM : 3;
constexpr unsigned FULL = 0xffffffffu;
static_assert(4 * SMEM_MAX_Q <= 64, "a thread's slot bits must fit 64 bits");
static_assert(THREADS % 32 == 0 && THREADS <= 512, "warps per block");
static_assert(CLUSTER_Q >= 1 &&
                  4 * CLUSTER_Q * THREADS * CLUSTER == MAX_CAPACITY,
              "the cluster's runs must cover MAX_CAPACITY exactly");
static_assert(CLUSTER_MIN_BLOCKS >= 1, "a cluster CTA must fit an SM");

enum {
  F_LENGTH, F_SEQ, F_CLIENT, F_REMOVED_SEQ, F_REMOVERS, F_OP_ID,
  F_OP_OFF, F_IS_MARKER, F_PROP0,
};
enum {
  O_KIND, O_POS1, O_POS2, O_SEQ, O_REFSEQ, O_CLIENT, O_OP_ID, O_LENGTH,
  O_IS_MARKER, O_PROP_KEY, O_PROP_VAL, O_MIN_SEQ,
};

// Pointers of one SegmentTable: slot fields [D, C], prop [D, C, 4],
// per-doc scalars [D].
struct TablePtrs {
  int* f[NPLAIN];
  int* prop;
  int* count;
  int* min_seq;
  int* overflow;
};

struct Params {
  TablePtrs in;
  TablePtrs out;
  const int* ops[NOPS];  // OpBatch fields, [D, W]
  int D, C, W;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// component i of a vector; i is a constant after unrolling
__device__ __forceinline__ int at(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The document's slot state in shared memory, [field][Cs] (Cs a
// multiple of 4, so a quad of slots is one aligned vector); ``base`` is
// the slot held in column 0 (0, or a cluster rank's first slot).
struct Slab {
  int* s;
  int Cs;
  int base;

  __device__ __forceinline__ int* addr(int f, int j) const {
    return s + f * Cs + (j - base);
  }
  __device__ __forceinline__ int ld(int f, int j) const {
    return *addr(f, j);
  }
  // slots j..j+3, j a multiple of 4
  __device__ __forceinline__ int4 ld4(int f, int j) const {
    return *reinterpret_cast<const int4*>(addr(f, j));
  }
  __device__ __forceinline__ void st4(int f, int j, int4 v) const {
    *reinterpret_cast<int4*>(addr(f, j)) = v;
  }
  // slots j, j+1, j even
  __device__ __forceinline__ int2 ld2(int f, int j) const {
    return *reinterpret_cast<const int2*>(addr(f, j));
  }
};

// Visible length of one slot at the view (refseq, client); ``stop`` is
// alive & not below the collab window.
__device__ __forceinline__ int view(int j, int rs, int rem, int sq, int cl,
                                    int len, int count, int min_seq,
                                    int refseq, int client, bool& stop) {
  const bool alive = j < count;
  const bool removed = rs != NOT_REMOVED;
  const bool below = removed && rs <= min_seq;
  const bool rm_by_viewer =
      (unsigned)client < 32u && (((unsigned)rem >> (unsigned)client) & 1u);
  const bool removal_visible = removed && (rs <= refseq || rm_by_viewer);
  const bool insert_visible = sq <= refseq || cl == client;
  stop = alive && !below;
  return stop && insert_visible && !removal_visible ? len : 0;
}

// Block-uniform scalars of one step's restructure and stamps.
struct Step {
  bool is_ins, is_rem, is_ann, u1, u2, fh1_on, fh2_on, stamping;
  int A, B, k1, h2;
  int off1h, len_at_A, len_h2, len_at_B, oo_at_A, oo_at_B;
  int op_seq, client, op_id, op_marker, prop_key, prop_val;
  unsigned bit;
};

// Rewrite the quad of slots jq..jq+3 as fused_step's restructure and
// stamps do. (pb2, pb1) are the old slots jq-2, jq-1 of each field when
// ``first`` (captured before the barrier: a neighbour owns them),
// otherwise read here (this thread owns them and writes them later);
// ``wbits`` are the fully-in-range bits of slots jq-2 .. jq+3.
__device__ __forceinline__ void restructure_quad(
    const Slab& S, const Step& st, int jq, bool first,
    const int* b2v, const int* b1v, unsigned wbits) {
  bool mv1[4], mv2[4], atA[4], newA[4], atB[4], fh1[4], fh2[4], stp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = jq + i;
    const int m = (int)(st.u1 && j >= st.A) + (int)(st.u2 && j >= st.B);
    mv1[i] = m == 1;
    mv2[i] = m == 2;
    atA[i] = st.u1 && j == st.A;
    newA[i] = atA[i] && st.is_ins;
    atB[i] = st.u2 && j == st.B;
    fh1[i] = st.fh1_on && j == st.k1;
    fh2[i] = st.fh2_on && j == st.h2;
    const bool mfi = (wbits >> (i + 2 - m)) & 1u;
    stp[i] = st.stamping && (mfi || atA[i] || fh2[i]);
  }
#pragma unroll
  for (int f = 0; f < NFIELD; ++f) {
    const int4 o = S.ld4(f, jq);
    int pb1, pb2;
    if (first) {
      pb1 = b1v[f];
      pb2 = b2v[f];
    } else {
      const int2 v = S.ld2(f, jq - 2);
      pb2 = v.x;
      pb1 = v.y;
    }
    int v[4];
    v[0] = mv2[0] ? pb2 : mv1[0] ? pb1 : o.x;
    v[1] = mv2[1] ? pb1 : mv1[1] ? o.x : o.y;
    v[2] = mv2[2] ? o.x : mv1[2] ? o.y : o.z;
    v[3] = mv2[3] ? o.y : mv1[3] ? o.z : o.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int x = v[i];
      if (f == F_LENGTH) {
        if (fh1[i]) x = st.off1h;
        if (atA[i]) x = st.len_at_A;
        if (fh2[i]) x = st.len_h2;
        if (atB[i]) x = st.len_at_B;
      } else if (f == F_OP_OFF) {
        if (atA[i]) x = st.oo_at_A;
        if (atB[i]) x = st.oo_at_B;
      } else if (f == F_SEQ) {
        if (newA[i]) x = st.op_seq;
      } else if (f == F_CLIENT) {
        if (newA[i]) x = st.client;
      } else if (f == F_OP_ID) {
        if (newA[i]) x = st.op_id;
      } else if (f == F_IS_MARKER) {
        if (newA[i]) x = st.op_marker;
      } else if (f == F_REMOVED_SEQ) {
        if (newA[i]) x = NOT_REMOVED;
        if (st.is_rem && stp[i] && x == NOT_REMOVED) x = st.op_seq;
      } else if (f == F_REMOVERS) {
        if (newA[i]) x = 0;
        if (st.is_rem && stp[i]) x = (int)((unsigned)x | st.bit);
      } else {  // prop channel f - F_PROP0
        if (newA[i]) x = 0;
        if (st.is_ann && stp[i] && st.prop_key == f - F_PROP0)
          x = st.prop_val;
      }
      v[i] = x;
    }
    S.st4(f, jq, make_int4(v[0], v[1], v[2], v[3]));
  }
}

// A quad that neither moves nor holds a split slot: only its stamped
// slots change, in removed_seq and removers, or in one prop channel.
__device__ __forceinline__ void stamp_quad(const Slab& S,
                                           const Step& st, int jq,
                                           unsigned bits) {
  if (st.is_rem) {
    int4 rs = S.ld4(F_REMOVED_SEQ, jq);
    int4 rm = S.ld4(F_REMOVERS, jq);
    int r[4] = {rs.x, rs.y, rs.z, rs.w};
    int b[4] = {rm.x, rm.y, rm.z, rm.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((bits >> i) & 1u) {
        if (r[i] == NOT_REMOVED) r[i] = st.op_seq;
        b[i] = (int)((unsigned)b[i] | st.bit);
      }
    }
    S.st4(F_REMOVED_SEQ, jq, make_int4(r[0], r[1], r[2], r[3]));
    S.st4(F_REMOVERS, jq, make_int4(b[0], b[1], b[2], b[3]));
  } else if ((unsigned)st.prop_key < (unsigned)PROP_CHANNELS) {
    const int f = F_PROP0 + st.prop_key;
    const int4 pv = S.ld4(f, jq);
    int x[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((bits >> i) & 1u) x[i] = st.prop_val;
    S.st4(f, jq, make_int4(x[0], x[1], x[2], x[3]));
  }
}

template <int Q>
__global__ void __launch_bounds__(
    THREADS, Q == MAIN_Q ? MAIN_MIN_BLOCKS : 1)
merge_window_kernel(const Params p) {
  constexpr int SL = 4 * Q;  // slots per thread
  // one bit per slot of the thread
  using Bits = typename std::conditional<(SL > 32), unsigned long long,
                                         unsigned>::type;
  extern __shared__ int4 smem4[];
  __shared__ __align__(16) int wsum[NWARPS];
  __shared__ int4 red[NLOOK][NWARPS];    // (idx, E, incl, op_off)
  __shared__ __align__(16) unsigned hits[2][4];  // warps with a hit

  int* smem = reinterpret_cast<int*>(smem4);
  const int d = blockIdx.x;
  const int C = p.C;
  const int W = p.W;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Cs = (C + 3) & ~3;
  const int j0 = tid * SL;
  const size_t row = (size_t)d * C;
  // fully-in-range bits of each thread's last two slots, read by its
  // successor
  unsigned* fiq = reinterpret_cast<unsigned*>(smem + NFIELD * Cs);
  const Slab S{smem, Cs, 0};

  // ---- load the live slots once ----------------------------------------
  const int count0 = p.in.count[d];
  int count = count0;
  int min_seq = p.in.min_seq[d];
  int overflow = p.in.overflow[d];
  const int nload = min(C, max(0, (count0 + 3) & ~3));
  for (int j = tid; j < nload; j += T) {
#pragma unroll
    for (int f = 0; f < NPLAIN; ++f) *S.addr(f, j) = p.in.f[f][row + j];
    const int4 v = reinterpret_cast<const int4*>(p.in.prop)[row + j];
    *S.addr(F_PROP0 + 0, j) = v.x;
    *S.addr(F_PROP0 + 1, j) = v.y;
    *S.addr(F_PROP0 + 2, j) = v.z;
    *S.addr(F_PROP0 + 3, j) = v.w;
  }
  if (tid < NWARPS) wsum[tid] = 0;
  if (tid < 8) hits[tid >> 2][tid & 3] = 0;
  __syncthreads();

  unsigned par = 0;  // parity of the non-NOOP steps so far
  for (int w = 0; w < W; ++w) {
    const size_t o = (size_t)d * W + w;
    const int kind = __ldg(p.ops[O_KIND] + o);
    const int op_min_seq = __ldg(p.ops[O_MIN_SEQ] + o);
    const bool is_ins = kind == KIND_INSERT;
    const bool is_rem = kind == KIND_REMOVE;
    const bool is_ann = kind == KIND_ANNOTATE;
    if (!(is_ins || is_rem || is_ann)) {  // NOOP: block-uniform
      min_seq = max(min_seq, op_min_seq);
      continue;
    }
    const bool is_range = is_rem || is_ann;
    const int p1 = __ldg(p.ops[O_POS1] + o);
    const int p2 = __ldg(p.ops[O_POS2] + o);
    const int refseq = __ldg(p.ops[O_REFSEQ] + o);
    const int client = __ldg(p.ops[O_CLIENT] + o);

    // ---- view pass over my live slots; thread sums -------------------
    int vlen[SL];
    Bits stopb = 0;
    int tsum = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int jq = j0 + 4 * q;
      if (jq < count) {
        const int4 rs = S.ld4(F_REMOVED_SEQ, jq);
        const int4 rm = S.ld4(F_REMOVERS, jq);
        const int4 sq = S.ld4(F_SEQ, jq);
        const int4 cl = S.ld4(F_CLIENT, jq);
        const int4 ln = S.ld4(F_LENGTH, jq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool stop;
          vlen[4 * q + i] = view(jq + i, at(rs, i), at(rm, i), at(sq, i),
                                 at(cl, i), at(ln, i), count, min_seq,
                                 refseq, client, stop);
          stopb |= (Bits)stop << (4 * q + i);
          tsum = wadd(tsum, vlen[4 * q + i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) vlen[4 * q + i] = 0;
      }
    }

    // ---- exclusive scan: warp shuffles, warp totals, barrier 1 --------
    int incl_w = tsum;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int v = __shfl_up_sync(FULL, incl_w, k);
      if (lane >= k) incl_w = wadd(incl_w, v);
    }
    if (lane == 31) wsum[warp] = incl_w;
    __syncthreads();
    int woff = 0, total = 0;
#pragma unroll
    for (int k = 0; k < NWARPS; ++k) {
      const int v = wsum[k];
      if (k < warp) woff = wadd(woff, v);
      total = wadd(total, v);
    }

    // ---- masks of my slots, first true of each -----------------------
    Bits tb = 0, ab = 0, bb = 0, fib = 0;
    int tE = 0, tI = 0, tk = 0, aE = 0, aI = 0, ak = 0, bE = 0, bI = 0,
        bk = 0;
    if (j0 < count) {
      int run = wadd(woff, wsub(incl_w, tsum));
#pragma unroll
      for (int k = 0; k < SL; ++k) {
        const int E = run;
        const int incl = wadd(run, vlen[k]);
        run = incl;
        const bool stop = (stopb >> k) & 1u;
        const bool t = stop && ((E <= p1 && p1 < incl) || E == p1);
        const bool a = E < p1 && p1 < incl;
        const bool b = E < p2 && p2 < incl;
        const bool fi = vlen[k] > 0 && E >= p1 && incl <= p2;
        if (t && !tb) { tE = E; tI = incl; tk = k; }
        if (a && !ab) { aE = E; aI = incl; ak = k; }
        if (b && !bb) { bE = E; bI = incl; bk = k; }
        tb |= (Bits)t << k;
        ab |= (Bits)a << k;
        bb |= (Bits)b << k;
        fib |= (Bits)fi << k;
      }
      fiq[tid] = (unsigned)(fib >> (SL - 2));
    }
    // the first lane with a hit, in the first warp with a hit, holds the
    // first true slot of the block
    const unsigned vt = __ballot_sync(FULL, tb != 0);
    const unsigned va = __ballot_sync(FULL, ab != 0);
    const unsigned vb = __ballot_sync(FULL, bb != 0);
    if (vt && lane == __ffs(vt) - 1) {
      red[0][warp] = make_int4(j0 + tk, tE, tI, S.ld(F_OP_OFF, j0 + tk));
      atomicOr(&hits[par][0], 1u << warp);
    }
    if (va && lane == __ffs(va) - 1) {
      red[1][warp] = make_int4(j0 + ak, aE, aI, S.ld(F_OP_OFF, j0 + ak));
      atomicOr(&hits[par][1], 1u << warp);
    }
    if (vb && lane == __ffs(vb) - 1) {
      red[2][warp] = make_int4(j0 + bk, bE, bI, S.ld(F_OP_OFF, j0 + bk));
      atomicOr(&hits[par][2], 1u << warp);
    }

    // old values of the two slots before my run (the restructure shifts
    // right by at most 2, and their owner rewrites them after barrier 2)
    int b1v[NFIELD], b2v[NFIELD];
    const bool capture = j0 > 0 && j0 < count + 2 && j0 < C;
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) {
      int2 v = make_int2(0, 0);
      if (capture) v = S.ld2(f, j0 - 2);
      b2v[f] = v.x;
      b1v[f] = v.y;
    }
    __syncthreads();
    if (tid < NLOOK) hits[par ^ 1u][tid] = 0;  // for the next step

    // ---- the three lookups, block-uniform ------------------------------
    const unsigned h0 = hits[par][0], h1 = hits[par][1], h2w = hits[par][2];
    int idx_t = count, E_t = BIG, incl_t = BIG;
    int opoff_t = BIG & (OPOFF_BOUND - 1);
    if (h0) {
      const int4 r = red[0][__ffs(h0) - 1];
      idx_t = r.x; E_t = r.y; incl_t = r.z;
      opoff_t = r.w & (OPOFF_BOUND - 1);
    }
    int idx1 = C, E_1 = BIG, incl_1 = BIG;
    int opoff_1 = BIG & (OPOFF_BOUND - 1);
    if (h1) {
      const int4 r = red[1][__ffs(h1) - 1];
      idx1 = r.x; E_1 = r.y; incl_1 = r.z;
      opoff_1 = r.w & (OPOFF_BOUND - 1);
    }
    int idx2 = C, E_2 = BIG, incl_2 = BIG;
    int opoff_2 = BIG & (OPOFF_BOUND - 1);
    if (h2w) {
      const int4 r = red[2][__ffs(h2w) - 1];
      idx2 = r.x; E_2 = r.y; incl_2 = r.z;
      opoff_2 = r.w & (OPOFF_BOUND - 1);
    }

    // ---- restructure scalars, as fused_step --------------------------
    const bool found_t = idx_t < count;
    const int off_ins = found_t ? wsub(p1, E_t) : 0;
    const bool s1 = idx1 < C;
    const int off1 = s1 ? wsub(p1, E_1) : 0;
    const bool s2 = idx2 < C;
    const int off2 = s2 ? wsub(p2, E_2) : 0;
    const bool same = s1 && s2 && idx1 == idx2;

    const bool valid_ins = is_ins && p1 <= total;
    const bool split_ins = valid_ins && off_ins > 0;
    bool u1 = valid_ins || (is_range && s1);
    bool u2 = split_ins || (is_range && s2);
    const int added = (int)u1 + (int)u2;
    const bool skip = added > 0 && count + added > C;
    u1 = u1 && !skip;
    u2 = u2 && !skip;

    Step st;
    st.is_ins = is_ins;
    st.is_rem = is_rem;
    st.is_ann = is_ann;
    st.u1 = u1;
    st.u2 = u2;
    st.k1 = is_ins ? idx_t : idx1;
    st.A = is_ins ? idx_t + (int)split_ins : idx1 + 1;
    st.h2 = idx2 + (int)s1;
    st.B = is_ins ? st.A + 1 : st.h2 + 1;
    const int len_k1 = is_ins ? wsub(incl_t, E_t) : wsub(incl_1, E_1);
    const int len_k2 = wsub(incl_2, E_2);
    const int opoff_k1 = is_ins ? opoff_t : opoff_1;
    st.fh1_on = !skip && (split_ins || (is_range && s1));
    st.fh2_on = !skip && is_range && s2;
    st.stamping = is_range && !skip;
    st.off1h = is_ins ? off_ins : off1;
    st.len_h2 = wsub(off2, same ? off1 : 0);
    st.op_seq = __ldg(p.ops[O_SEQ] + o);
    st.client = client;
    st.bit = (unsigned)client < 32u ? 1u << client : 0u;
    st.len_at_A =
        is_ins ? __ldg(p.ops[O_LENGTH] + o) : wsub(len_k1, off1);
    st.len_at_B = is_ins ? wsub(len_k1, off_ins) : wsub(len_k2, off2);
    st.oo_at_A = is_ins ? 0 : wadd(opoff_k1, off1);
    st.oo_at_B = is_ins ? wadd(opoff_k1, off_ins) : wadd(opoff_2, off2);

    // ---- restructure + stamps, in place, my top quad first -----------
    const int n_after = skip ? count : count + added;
    const int lo_move = u1 ? st.A : (u2 ? st.B : BIG);
    if (j0 < n_after) {
      st.op_id = __ldg(p.ops[O_OP_ID] + o);
      st.op_marker = __ldg(p.ops[O_IS_MARKER] + o);
      st.prop_key = __ldg(p.ops[O_PROP_KEY] + o);
      st.prop_val = __ldg(p.ops[O_PROP_VAL] + o);
#pragma unroll
      for (int q = Q - 1; q >= 0; --q) {
        const int jq = j0 + 4 * q;
        if (jq >= n_after) continue;
        const bool moved = jq + 3 >= lo_move;
        const bool split_here =
            (st.fh1_on && st.k1 >= jq && st.k1 < jq + 4) ||
            (st.fh2_on && st.h2 >= jq && st.h2 < jq + 4);
        if (moved || split_here) {
          unsigned prev = 0;  // fully-in bits of slots jq-2, jq-1
          if (q > 0)
            prev = (unsigned)(fib >> (4 * q - 2)) & 3u;
          else if (j0 > 0)
            prev = fiq[tid - 1];
          const unsigned wbits =
              prev | (((unsigned)(fib >> (4 * q)) & 15u) << 2);
          restructure_quad(S, st, jq, q == 0, b2v, b1v, wbits);
        } else {
          const unsigned bits = (unsigned)(fib >> (4 * q)) & 15u;
          if (st.stamping && bits) stamp_quad(S, st, jq, bits);
        }
      }
    }

    // ---- doc scalars --------------------------------------------------
    if (!skip) count = wadd(count, added);
    min_seq = max(min_seq, op_min_seq);
    if (skip) overflow = 1;
    par ^= 1u;
  }

  // ---- write the state once: the live slots from the slab, the garbage
  // tail from the input shifted right by the window's growth ------------
  __syncthreads();
  const int grown = count - count0;
  int4* out_prop = reinterpret_cast<int4*>(p.out.prop);
  const int4* in_prop = reinterpret_cast<const int4*>(p.in.prop);
  for (int j = tid; j < C; j += T) {
    if (j < count) {
#pragma unroll
      for (int f = 0; f < NPLAIN; ++f)
        p.out.f[f][row + j] = smem[f * Cs + j];
      out_prop[row + j] = make_int4(
          smem[(F_PROP0 + 0) * Cs + j], smem[(F_PROP0 + 1) * Cs + j],
          smem[(F_PROP0 + 2) * Cs + j], smem[(F_PROP0 + 3) * Cs + j]);
    } else {
      const size_t src = row + (j - grown);
#pragma unroll
      for (int f = 0; f < NPLAIN; ++f) p.out.f[f][row + j] = p.in.f[f][src];
      out_prop[row + j] = in_prop[src];
    }
  }
  if (tid == 0) {
    p.out.count[d] = count;
    p.out.min_seq[d] = min_seq;
    p.out.overflow[d] = overflow;
  }
}

// Distributed shared memory by 32-bit shared::cluster addresses. The
// mapping is asm volatile so that it is made where it is used: hoisted
// out of the step loop, the mapped addresses of every rank's buffers
// held registers for the whole window and spilled.
__device__ __forceinline__ unsigned rank_addr(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void st_rank(unsigned a, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_rank(unsigned a, int4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void or_rank(unsigned a, unsigned v) {
  asm volatile("red.shared::cluster.or.b32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}
__device__ __forceinline__ int2 ld_rank(unsigned a) {
  int2 v;
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

// The cluster form: one cluster of CL CTAs per document (grid D * CL),
// rank r holding the slots [r*span, (r+1)*span) of [0, C) in its shared
// memory, T = span / (4*Q) threads each owning a run of 4*Q slots. Each
// step is the main kernel's, with its two barriers made cluster-wide
// and what crosses a span pushed through DSMEM (see the file's head).
// Every buffer another rank writes into is single: it is written only
// between two barriers and read only between the next two, and its
// writer cannot reach the next write before passing the barrier that
// follows the reads:
//  * wsum: pushed before barrier 1, read between barriers 1 and 2; the
//    next push comes after the restructure, after barrier 2;
//  * red, fiq_in: pushed between barriers 1 and 2, read after barrier
//    2; the next push comes after the next step's barrier 1, and every
//    rank reads before it arrives there;
//  * hits[par]: ORed between barriers 1 and 2 of a step of parity par,
//    read after its barrier 2; each rank clears its own hits[par ^ 1]
//    after barrier 2, before it arrives at the barrier 1 that precedes
//    the next step's ORs into it, and after its own reads of that
//    parity, which came before the barrier 1 it has passed.
template <int CL, int Q>
__global__ void __launch_bounds__(THREADS, CLUSTER_MIN_BLOCKS)
merge_window_cluster_kernel(const Params p) {
  constexpr int SL = 4 * Q;          // slots per thread
  constexpr int NW = CL * NWARPS;    // warps of a cluster, ranks major
  using Bits = typename std::conditional<(SL > 32), unsigned long long,
                                         unsigned>::type;
  extern __shared__ int4 smem4[];
  __shared__ __align__(16) int wsum[NW];        // warp totals
  __shared__ int4 red[NLOOK][NW];               // (idx, E, incl, op_off)
  __shared__ unsigned hits[2][NLOOK][CL];       // warps with a hit, by rank
  __shared__ unsigned fiq_in;  // rank r-1's fully-in bits of its last two

  cg::cluster_group cluster = cg::this_cluster();
  int* smem = reinterpret_cast<int*>(smem4);
  const int r = (int)cluster.block_rank();
  const int d = blockIdx.x / CL;
  const int C = p.C;
  const int W = p.W;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int me = r * NWARPS + warp;  // this warp's bit in the cluster
  const int span = T * SL;
  const int base = r * span;
  const int end = min(base + span, C);  // my slots are [base, end)
  const int j0 = base + tid * SL;
  const size_t row = (size_t)d * C;
  unsigned* fiq = reinterpret_cast<unsigned*>(smem + NFIELD * span);
  const Slab S{smem, span, base};

  // ---- the ranks this window can reach: count grows by at most 2 a
  // step, so a rank whose span starts at or above count0 + 2W never holds
  // a live slot. Those leave at once (a cluster barrier waits for the
  // threads that have not exited); nothing is pushed into them, and the
  // last rank that stays writes their slots of the garbage tail ---------
  const int count0 = p.in.count[d];
  const int reach = min(C, count0 + 2 * W);
  const int active = max(1, min(CL, (reach + span - 1) / span));
  if (r >= active) return;

  // ---- load my span's live slots once ----------------------------------
  int count = count0;
  int min_seq = p.in.min_seq[d];
  int overflow = p.in.overflow[d];
  const int nload = min(end, max(0, (count0 + 3) & ~3));
  for (int j = base + tid; j < nload; j += T) {
#pragma unroll
    for (int f = 0; f < NPLAIN; ++f) *S.addr(f, j) = p.in.f[f][row + j];
    const int4 v = reinterpret_cast<const int4*>(p.in.prop)[row + j];
    *S.addr(F_PROP0 + 0, j) = v.x;
    *S.addr(F_PROP0 + 1, j) = v.y;
    *S.addr(F_PROP0 + 2, j) = v.z;
    *S.addr(F_PROP0 + 3, j) = v.w;
  }
  for (int k = tid; k < NW; k += T) wsum[k] = 0;
  for (int k = tid; k < 2 * NLOOK * CL; k += T) (&hits[0][0][0])[k] = 0;
  if (tid == 0) fiq_in = 0;
  cluster.sync();  // every rank zeroed before any rank writes into it

  unsigned par = 0;  // parity of the non-NOOP steps so far
  for (int w = 0; w < W; ++w) {
    const size_t o = (size_t)d * W + w;
    const int kind = __ldg(p.ops[O_KIND] + o);
    const int op_min_seq = __ldg(p.ops[O_MIN_SEQ] + o);
    const bool is_ins = kind == KIND_INSERT;
    const bool is_rem = kind == KIND_REMOVE;
    const bool is_ann = kind == KIND_ANNOTATE;
    if (!(is_ins || is_rem || is_ann)) {  // NOOP: cluster-uniform
      min_seq = max(min_seq, op_min_seq);
      continue;
    }
    const bool is_range = is_rem || is_ann;
    const int p1 = __ldg(p.ops[O_POS1] + o);
    const int p2 = __ldg(p.ops[O_POS2] + o);
    const int refseq = __ldg(p.ops[O_REFSEQ] + o);
    const int client = __ldg(p.ops[O_CLIENT] + o);

    // ---- view pass over my live slots; thread sums -------------------
    int vlen[SL];
    Bits stopb = 0;
    int tsum = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int jq = j0 + 4 * q;
      if (jq < count) {
        const int4 rs = S.ld4(F_REMOVED_SEQ, jq);
        const int4 rm = S.ld4(F_REMOVERS, jq);
        const int4 sq = S.ld4(F_SEQ, jq);
        const int4 cl = S.ld4(F_CLIENT, jq);
        const int4 ln = S.ld4(F_LENGTH, jq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool stop;
          vlen[4 * q + i] = view(jq + i, at(rs, i), at(rm, i), at(sq, i),
                                 at(cl, i), at(ln, i), count, min_seq,
                                 refseq, client, stop);
          stopb |= (Bits)stop << (4 * q + i);
          tsum = wadd(tsum, vlen[4 * q + i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) vlen[4 * q + i] = 0;
      }
    }

    // ---- exclusive scan: warp shuffles, warp totals pushed to every
    // rank, cluster barrier 1, the totals read back per warp ------------
    int incl_w = tsum;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int v = __shfl_up_sync(FULL, incl_w, k);
      if (lane >= k) incl_w = wadd(incl_w, v);
    }
    if (lane == 31) {
#pragma unroll
      for (int q = 0; q < CL; ++q)
        if (q < active) st_rank(rank_addr(&wsum[me], q), incl_w);
    }
    cluster.sync();
    int woff = 0, total = 0;
    for (int k = lane; k < NW; k += 32) {
      const int v = wsum[k];
      if (k < me) woff = wadd(woff, v);
      total = wadd(total, v);
    }
#pragma unroll
    for (int k = 16; k >= 1; k >>= 1) {
      woff = wadd(woff, __shfl_xor_sync(FULL, woff, k));
      total = wadd(total, __shfl_xor_sync(FULL, total, k));
    }

    // ---- masks of my slots, first true of each -----------------------
    Bits tb = 0, ab = 0, bb = 0, fib = 0;
    int tE = 0, tI = 0, tk = 0, aE = 0, aI = 0, ak = 0, bE = 0, bI = 0,
        bk = 0;
    if (j0 < count) {
      int run = wadd(woff, wsub(incl_w, tsum));
#pragma unroll
      for (int k = 0; k < SL; ++k) {
        const int E = run;
        const int incl = wadd(run, vlen[k]);
        run = incl;
        const bool stop = (stopb >> k) & 1u;
        const bool t = stop && ((E <= p1 && p1 < incl) || E == p1);
        const bool a = E < p1 && p1 < incl;
        const bool b = E < p2 && p2 < incl;
        const bool fi = vlen[k] > 0 && E >= p1 && incl <= p2;
        if (t && !tb) { tE = E; tI = incl; tk = k; }
        if (a && !ab) { aE = E; aI = incl; ak = k; }
        if (b && !bb) { bE = E; bI = incl; bk = k; }
        tb |= (Bits)t << k;
        ab |= (Bits)a << k;
        bb |= (Bits)b << k;
        fib |= (Bits)fi << k;
      }
      const unsigned last2 = (unsigned)(fib >> (SL - 2));
      fiq[tid] = last2;
      if (tid == T - 1 && r + 1 < active)
        st_rank(rank_addr(&fiq_in, r + 1), (int)last2);
    }
    // the first lane with a hit, in the first warp of the first rank
    // with a hit, holds the first true slot of the document
    const unsigned vt = __ballot_sync(FULL, tb != 0);
    const unsigned va = __ballot_sync(FULL, ab != 0);
    const unsigned vb = __ballot_sync(FULL, bb != 0);
    const unsigned bit = 1u << warp;
    if (vt && lane == __ffs(vt) - 1) {
      const int4 rec = make_int4(j0 + tk, tE, tI, S.ld(F_OP_OFF, j0 + tk));
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        if (q >= active) continue;
        st_rank(rank_addr(&red[0][me], q), rec);
        or_rank(rank_addr(&hits[par][0][r], q), bit);
      }
    }
    if (va && lane == __ffs(va) - 1) {
      const int4 rec = make_int4(j0 + ak, aE, aI, S.ld(F_OP_OFF, j0 + ak));
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        if (q >= active) continue;
        st_rank(rank_addr(&red[1][me], q), rec);
        or_rank(rank_addr(&hits[par][1][r], q), bit);
      }
    }
    if (vb && lane == __ffs(vb) - 1) {
      const int4 rec = make_int4(j0 + bk, bE, bI, S.ld(F_OP_OFF, j0 + bk));
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        if (q >= active) continue;
        st_rank(rank_addr(&red[2][me], q), rec);
        or_rank(rank_addr(&hits[par][2][r], q), bit);
      }
    }

    // old values of the two slots before my run (the restructure shifts
    // right by at most 2, and their owner rewrites them after barrier 2);
    // thread 0 of rank r > 0 reads them from rank r-1's last two columns
    int b1v[NFIELD], b2v[NFIELD];
    const bool capture = j0 > 0 && j0 < count + 2 && j0 < C;
    const bool remote = tid == 0 && r > 0;
    const unsigned prev_rank = remote ? rank_addr(smem, r - 1) : 0u;
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) {
      int2 v = make_int2(0, 0);
      if (capture && remote)
        v = ld_rank(prev_rank + (unsigned)((f + 1) * span - 2) * 4u);
      else if (capture)
        v = S.ld2(f, j0 - 2);
      b2v[f] = v.x;
      b1v[f] = v.y;
    }
    cluster.sync();
    if (tid < NLOOK * CL) (&hits[par ^ 1u][0][0])[tid] = 0;  // next step

    // ---- the three lookups, cluster-uniform: the first warp with a hit
    // in the first rank with one --------------------------------------
    int first[NLOOK];
#pragma unroll
    for (int k = 0; k < NLOOK; ++k) {
      first[k] = -1;
#pragma unroll
      for (int q = CL - 1; q >= 0; --q) {
        const unsigned h = hits[par][k][q];
        if (h) first[k] = q * NWARPS + __ffs(h) - 1;
      }
    }
    int idx_t = count, E_t = BIG, incl_t = BIG;
    int opoff_t = BIG & (OPOFF_BOUND - 1);
    if (first[0] >= 0) {
      const int4 rr = red[0][first[0]];
      idx_t = rr.x; E_t = rr.y; incl_t = rr.z;
      opoff_t = rr.w & (OPOFF_BOUND - 1);
    }
    int idx1 = C, E_1 = BIG, incl_1 = BIG;
    int opoff_1 = BIG & (OPOFF_BOUND - 1);
    if (first[1] >= 0) {
      const int4 rr = red[1][first[1]];
      idx1 = rr.x; E_1 = rr.y; incl_1 = rr.z;
      opoff_1 = rr.w & (OPOFF_BOUND - 1);
    }
    int idx2 = C, E_2 = BIG, incl_2 = BIG;
    int opoff_2 = BIG & (OPOFF_BOUND - 1);
    if (first[2] >= 0) {
      const int4 rr = red[2][first[2]];
      idx2 = rr.x; E_2 = rr.y; incl_2 = rr.z;
      opoff_2 = rr.w & (OPOFF_BOUND - 1);
    }

    // ---- restructure scalars, as fused_step --------------------------
    const bool found_t = idx_t < count;
    const int off_ins = found_t ? wsub(p1, E_t) : 0;
    const bool s1 = idx1 < C;
    const int off1 = s1 ? wsub(p1, E_1) : 0;
    const bool s2 = idx2 < C;
    const int off2 = s2 ? wsub(p2, E_2) : 0;
    const bool same = s1 && s2 && idx1 == idx2;

    const bool valid_ins = is_ins && p1 <= total;
    const bool split_ins = valid_ins && off_ins > 0;
    bool u1 = valid_ins || (is_range && s1);
    bool u2 = split_ins || (is_range && s2);
    const int added = (int)u1 + (int)u2;
    const bool skip = added > 0 && count + added > C;
    u1 = u1 && !skip;
    u2 = u2 && !skip;

    Step st;
    st.is_ins = is_ins;
    st.is_rem = is_rem;
    st.is_ann = is_ann;
    st.u1 = u1;
    st.u2 = u2;
    st.k1 = is_ins ? idx_t : idx1;
    st.A = is_ins ? idx_t + (int)split_ins : idx1 + 1;
    st.h2 = idx2 + (int)s1;
    st.B = is_ins ? st.A + 1 : st.h2 + 1;
    const int len_k1 = is_ins ? wsub(incl_t, E_t) : wsub(incl_1, E_1);
    const int len_k2 = wsub(incl_2, E_2);
    const int opoff_k1 = is_ins ? opoff_t : opoff_1;
    st.fh1_on = !skip && (split_ins || (is_range && s1));
    st.fh2_on = !skip && is_range && s2;
    st.stamping = is_range && !skip;
    st.off1h = is_ins ? off_ins : off1;
    st.len_h2 = wsub(off2, same ? off1 : 0);
    st.op_seq = __ldg(p.ops[O_SEQ] + o);
    st.client = client;
    st.bit = (unsigned)client < 32u ? 1u << client : 0u;
    st.len_at_A =
        is_ins ? __ldg(p.ops[O_LENGTH] + o) : wsub(len_k1, off1);
    st.len_at_B = is_ins ? wsub(len_k1, off_ins) : wsub(len_k2, off2);
    st.oo_at_A = is_ins ? 0 : wadd(opoff_k1, off1);
    st.oo_at_B = is_ins ? wadd(opoff_k1, off_ins) : wadd(opoff_2, off2);

    // ---- restructure + stamps, in place, my top quad first -----------
    const int n_after = skip ? count : count + added;
    const int lo_move = u1 ? st.A : (u2 ? st.B : BIG);
    if (j0 < n_after) {
      st.op_id = __ldg(p.ops[O_OP_ID] + o);
      st.op_marker = __ldg(p.ops[O_IS_MARKER] + o);
      st.prop_key = __ldg(p.ops[O_PROP_KEY] + o);
      st.prop_val = __ldg(p.ops[O_PROP_VAL] + o);
#pragma unroll
      for (int q = Q - 1; q >= 0; --q) {
        const int jq = j0 + 4 * q;
        if (jq >= n_after) continue;
        const bool moved = jq + 3 >= lo_move;
        const bool split_here =
            (st.fh1_on && st.k1 >= jq && st.k1 < jq + 4) ||
            (st.fh2_on && st.h2 >= jq && st.h2 < jq + 4);
        if (moved || split_here) {
          unsigned prev = 0;  // fully-in bits of slots jq-2, jq-1
          if (q > 0)
            prev = (unsigned)(fib >> (4 * q - 2)) & 3u;
          else if (j0 > 0)
            prev = tid > 0 ? fiq[tid - 1] : fiq_in;
          const unsigned wbits =
              prev | (((unsigned)(fib >> (4 * q)) & 15u) << 2);
          restructure_quad(S, st, jq, q == 0, b2v, b1v, wbits);
        } else {
          const unsigned bits = (unsigned)(fib >> (4 * q)) & 15u;
          if (st.stamping && bits) stamp_quad(S, st, jq, bits);
        }
      }
    }

    // ---- doc scalars --------------------------------------------------
    if (!skip) count = wadd(count, added);
    min_seq = max(min_seq, op_min_seq);
    if (skip) overflow = 1;
    par ^= 1u;
  }

  // ---- write my span once: the live slots from the slab, the garbage
  // tail from the input shifted right by the window's growth ------------
  cluster.sync();
  const int grown = count - count0;
  int4* out_prop = reinterpret_cast<int4*>(p.out.prop);
  const int4* in_prop = reinterpret_cast<const int4*>(p.in.prop);
  for (int j = base + tid; j < end; j += T) {
    if (j < count) {
#pragma unroll
      for (int f = 0; f < NPLAIN; ++f) p.out.f[f][row + j] = S.ld(f, j);
      out_prop[row + j] =
          make_int4(S.ld(F_PROP0 + 0, j), S.ld(F_PROP0 + 1, j),
                    S.ld(F_PROP0 + 2, j), S.ld(F_PROP0 + 3, j));
    } else {
      const size_t src = row + (j - grown);
#pragma unroll
      for (int f = 0; f < NPLAIN; ++f) p.out.f[f][row + j] = p.in.f[f][src];
      out_prop[row + j] = in_prop[src];
    }
  }
  // the last rank that stayed writes the spans of those that left, all
  // garbage tail
  if (r == active - 1) {
    for (int j = end + tid; j < C; j += T) {
      const size_t src = row + (j - grown);
#pragma unroll
      for (int f = 0; f < NPLAIN; ++f) p.out.f[f][row + j] = p.in.f[f][src];
      out_prop[row + j] = in_prop[src];
    }
  }
  if (r == 0 && tid == 0) {
    p.out.count[d] = count;
    p.out.min_seq[d] = min_seq;
    p.out.overflow[d] = overflow;
  }
}

template <int Q>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int quads = (p.C + 3) / 4;
  const int runs = (quads + Q - 1) / Q;
  const int rounded = (runs + 31) / 32 * 32;
  const int threads = rounded < THREADS ? rounded : THREADS;
  const int Cs = (p.C + 3) & ~3;
  const size_t shmem = (size_t)NFIELD * Cs * sizeof(int) +
                       (size_t)THREADS * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      merge_window_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return err;
  merge_window_kernel<Q><<<p.D, threads, shmem, stream>>>(p);
  return cudaGetLastError();
}

// the smallest Q from Q up whose 4*Q slots per thread cover C
template <int Q>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if constexpr (Q < SMEM_MAX_Q) {
    if (p.C > 4 * Q * THREADS) return dispatch<2 * Q>(p, stream);
  }
  return launch<Q>(p, stream);
}

// Span of a cluster rank at capacity C: ceil(C / CLUSTER) slots rounded
// up to whole warps' runs, so that its T = span / (4 * CLUSTER_Q)
// threads are whole warps, each owning 4 * CLUSTER_Q slots.
int cluster_span(int C) {
  constexpr int unit = 32 * 4 * CLUSTER_Q;
  return ((C + CLUSTER - 1) / CLUSTER + unit - 1) / unit * unit;
}

// The cluster form's launch configuration at capacity C (``attr`` is
// the cluster-shape attribute it points to), with the kernel's dynamic
// shared memory raised to what the span needs.
cudaError_t cluster_config(int D, int C, cudaStream_t stream,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  const int span = cluster_span(C);
  const int threads = span / (4 * CLUSTER_Q);
  const size_t shmem = (size_t)NFIELD * span * sizeof(int) +
                       (size_t)threads * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      merge_window_cluster_kernel<CLUSTER, CLUSTER_Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)D * CLUSTER);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = shmem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// What merge_window_launch returns when no cluster of the form's shape
// can be resident on the current device.
constexpr int ERR_NO_CLUSTER = -2;

// Clusters of the form's shape at capacity C that can be resident at
// once on the current device (cudaOccupancyMaxActiveClusters), or a
// negative cudaError_t. Asked once per span and device, then kept.
int max_active_clusters(int C) {
  constexpr int MAX_DEVICES = 64;
  constexpr int SPANS = MAX_CAPACITY / CLUSTER / (32 * 4 * CLUSTER_Q) + 1;
  // 0: not asked yet; else n + 1 (launching threads may race to fill it)
  static std::atomic<int> known[MAX_DEVICES][SPANS];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  const int slot = cluster_span(C) / (32 * 4 * CLUSTER_Q);
  if (dev < MAX_DEVICES && known[dev][slot] > 0) return known[dev][slot] - 1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = cluster_config(1, C, 0, &attr, &cfg);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &n, merge_window_cluster_kernel<CLUSTER, CLUSTER_Q>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  if (dev < MAX_DEVICES) known[dev][slot] = n + 1;
  return n;
}

cudaError_t launch_cluster(const Params& p, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(p.D, p.C, stream, &attr, &cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, merge_window_cluster_kernel<CLUSTER, CLUSTER_Q>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes.
//   ptrs: 36 device pointers — the input table's 12 tensors and the
//   output table's 12 (SegmentTable field order: length, seq, client,
//   removed_seq, removers, op_id, op_off, is_marker, prop, count,
//   min_seq, overflow), then the 12 OpBatch fields (kind, pos1, pos2,
//   seq, refseq, client, op_id, length, is_marker, prop_key, prop_val,
//   min_seq).
// Launches on ``stream``, allocates nothing, does not synchronise.
// Returns the launch's cudaError_t, -1 for arguments the kernel does
// not take, or -2 when the cluster form (C > 4096) cannot be resident.
extern "C" int merge_window_launch(void* const* ptrs, int D, int C, int W,
                                   void* stream) {
  if (D <= 0 || C <= 0 || W < 0 || C > MAX_CAPACITY) return -1;
  Params p;
  TablePtrs* tabs[2] = {&p.in, &p.out};
  for (int t = 0; t < 2; ++t) {
    void* const* q = ptrs + 12 * t;
    for (int f = 0; f < NPLAIN; ++f) tabs[t]->f[f] = (int*)q[f];
    tabs[t]->prop = (int*)q[8];
    tabs[t]->count = (int*)q[9];
    tabs[t]->min_seq = (int*)q[10];
    tabs[t]->overflow = (int*)q[11];
  }
  for (int f = 0; f < NOPS; ++f) p.ops[f] = (const int*)ptrs[24 + f];
  p.D = D;
  p.C = C;
  p.W = W;
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= SMEM_MAX_CAPACITY) return (int)dispatch<1>(p, s);
  const int active = max_active_clusters(C);
  if (active < 0) return -active;
  if (active == 0) return ERR_NO_CLUSTER;
  return (int)launch_cluster(p, s);
}

// The cluster form's shape at capacity C (4096 < C <= 8192): CTAs per
// document, slots per CTA, threads per CTA, and the clusters that can be
// resident at once on the current device. Returns 0, -1 for a capacity
// the form does not take, or a cudaError_t.
extern "C" int merge_window_cluster_shape(int C, int* out) {
  if (C <= SMEM_MAX_CAPACITY || C > MAX_CAPACITY) return -1;
  const int active = max_active_clusters(C);
  if (active < 0) return -active;
  out[0] = CLUSTER;
  out[1] = cluster_span(C);
  out[2] = cluster_span(C) / (4 * CLUSTER_Q);
  out[3] = active;
  return 0;
}

extern "C" const char* merge_window_error_string(int err) {
  if (err == ERR_NO_CLUSTER)
    return "no cluster of the large-capacity form can be resident on this "
           "device";
  return cudaGetErrorString((cudaError_t)err);
}
