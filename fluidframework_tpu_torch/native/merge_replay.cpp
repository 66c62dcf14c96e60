// Scalar merge-tree replayer — the compiled-language baseline for the
// batched window kernel (BASELINE.md: "Node.js baselines ... must be
// measured"; no Node runtime exists in this image, so the baseline
// proxy is this C++ -O2 replay of the same sequenced-path semantics,
// which bounds what a V8-JITted merge-tree could do on this host).
//
// Semantics mirror ops/merge_kernel.py (_views/_apply_one) and the
// scalar Python oracle (models/mergetree/mergetree.py), which encode
// the reference's refSeq-view resolution (mergeTree.ts insertingWalk
// :1723, markRangeRemoved :1908, annotateRange :1864) reduced to the
// server-side sequenced path (every seq acked).
//
// Input: row-major int32 ops [n_ops][12] in host_bridge.OP_FIELDS
// order: kind,pos1,pos2,seq,refseq,client,op_id,length,is_marker,
// prop_key,prop_val,min_seq.  Output: FNV-1a checksum over the
// per-character tip view — comparable with the kernel's fetched table.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kNotRemoved = INT32_MAX;
constexpr int kPropChannels = 4;
constexpr int kF_kind = 0, kF_pos1 = 1, kF_pos2 = 2, kF_seq = 3,
              kF_refseq = 4, kF_client = 5, kF_op_id = 6, kF_length = 7,
              kF_is_marker = 8, kF_prop_key = 9, kF_prop_val = 10,
              kF_min_seq = 11;
constexpr int kFields = 12;
constexpr int kKindInsert = 0, kKindRemove = 1, kKindAnnotate = 2,
              kKindNoop = 3;

struct Seg {
  int32_t length;
  int32_t seq;
  int32_t client;
  int32_t removed_seq;
  uint32_t removers;
  int32_t op_id;
  int32_t op_off;
  int32_t is_marker;
  int32_t prop[kPropChannels];
};

struct Doc {
  std::vector<Seg> segs;
  int32_t min_seq = 0;
  int32_t ops_since_compact = 0;

  bool below_window(const Seg& s) const {
    return s.removed_seq != kNotRemoved && s.removed_seq <= min_seq;
  }
  bool removal_visible(const Seg& s, int32_t refseq, int32_t client) const {
    return s.removed_seq != kNotRemoved &&
           (s.removed_seq <= refseq ||
            ((s.removers >> (static_cast<uint32_t>(client) & 31u)) & 1u));
  }
  bool insert_visible(const Seg& s, int32_t refseq, int32_t client) const {
    return s.seq <= refseq || s.client == client;
  }
  bool visible(const Seg& s, int32_t refseq, int32_t client) const {
    return !below_window(s) && insert_visible(s, refseq, client) &&
           !removal_visible(s, refseq, client);
  }

  // Split segs[i] at interior offset off; tail inherits provenance
  // (splitLeafSegment, mergeTree.ts:1681).
  void split(size_t i, int32_t off) {
    Seg tail = segs[i];
    tail.length = segs[i].length - off;
    tail.op_off = segs[i].op_off + off;
    segs[i].length = off;
    segs.insert(segs.begin() + i + 1, tail);
  }

  void insert(const int32_t* op) {
    int32_t p1 = op[kF_pos1], refseq = op[kF_refseq],
            client = op[kF_client];
    int64_t E = 0;
    size_t idx = segs.size();
    int32_t off = 0;
    for (size_t i = 0; i < segs.size(); ++i) {
      const Seg& s = segs[i];
      if (below_window(s)) continue;  // not stop-eligible
      int32_t vlen = visible(s, refseq, client) ? s.length : 0;
      if (E == p1 || (E <= p1 && p1 < E + vlen)) {
        idx = i;
        off = static_cast<int32_t>(p1 - E);
        break;
      }
      E += vlen;
    }
    if (idx == segs.size() && p1 > E) return;  // beyond total: invalid
    if (off > 0) {
      split(idx, off);
      ++idx;
    }
    Seg n{};
    n.length = op[kF_length];
    n.seq = op[kF_seq];
    n.client = client;
    n.removed_seq = kNotRemoved;
    n.op_id = op[kF_op_id];
    n.is_marker = op[kF_is_marker];
    segs.insert(segs.begin() + idx, n);
  }

  // Split at visible-position boundary p (for range ops): slot
  // strictly containing p splits so stamps align to op boundaries.
  void boundary(int32_t p, int32_t refseq, int32_t client) {
    int64_t E = 0;
    for (size_t i = 0; i < segs.size(); ++i) {
      const Seg& s = segs[i];
      if (below_window(s)) continue;
      int32_t vlen = visible(s, refseq, client) ? s.length : 0;
      if (E < p && p < E + vlen) {
        split(i, static_cast<int32_t>(p - E));
        return;
      }
      E += vlen;
      if (E >= p) return;  // E is monotone: no later slot contains p
    }
  }

  void range_stamp(const int32_t* op) {
    int32_t p1 = op[kF_pos1], p2 = op[kF_pos2], refseq = op[kF_refseq],
            client = op[kF_client], kind = op[kF_kind];
    boundary(p1, refseq, client);
    boundary(p2, refseq, client);
    // encode enforces client < 32 (DocStream.intern_client); the
    // clamp guards against UB if a hand-built stream violates it.
    uint32_t bit = 1u << (static_cast<uint32_t>(client) & 31u);
    int64_t E = 0;
    for (size_t i = 0; i < segs.size(); ++i) {
      Seg& s = segs[i];
      if (below_window(s)) continue;
      int32_t vlen = visible(s, refseq, client) ? s.length : 0;
      if (vlen > 0 && E >= p1 && E + vlen <= p2) {
        if (kind == kKindRemove) {
          if (s.removed_seq == kNotRemoved) s.removed_seq = op[kF_seq];
          s.removers |= bit;
        } else {  // annotate: sequenced-order LWW on one channel
          s.prop[op[kF_prop_key]] = op[kF_prop_val];
        }
      }
      E += vlen;
      if (E >= p2) break;
    }
  }

  // Zamboni analogue (mergeTree.ts:800): drop below-window tombstones
  // periodically so long sessions stay bounded, like the real client.
  void maybe_compact() {
    if (++ops_since_compact < 64) return;
    ops_since_compact = 0;
    size_t w = 0;
    for (size_t i = 0; i < segs.size(); ++i) {
      if (segs[i].removed_seq != kNotRemoved &&
          segs[i].removed_seq <= min_seq)
        continue;
      if (w != i) segs[w] = segs[i];
      ++w;
    }
    segs.resize(w);
  }

  void apply(const int32_t* op) {
    switch (op[kF_kind]) {
      case kKindInsert:
        insert(op);
        break;
      case kKindRemove:
      case kKindAnnotate:
        range_stamp(op);
        break;
      case kKindNoop:
      default:
        break;
    }
    if (op[kF_min_seq] > min_seq) min_seq = op[kF_min_seq];
    maybe_compact();
  }

  uint64_t checksum() const {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    auto mix = [&h](int64_t v) {
      for (int b = 0; b < 8; ++b) {
        h ^= static_cast<uint64_t>(v >> (8 * b)) & 0xffu;
        h *= 1099511628211ull;
      }
    };
    for (const Seg& s : segs) {
      if (s.removed_seq != kNotRemoved) continue;  // tip view
      for (int32_t c = 0; c < s.length; ++c) {
        mix(s.op_id);
        mix(s.op_off + c);
        mix(s.is_marker);
        for (int k = 0; k < kPropChannels; ++k) mix(s.prop[k]);
      }
    }
    return h;
  }
};

// Incremental multi-document session — the HOST SERVING TIER the
// full-service pipeline routes merges through on hosts without an
// accelerator (config5's CPU path; the sidecar's host tier uses the
// same engines). Unlike merge_replay (from-scratch, one doc), a
// session holds per-doc state across rounds and applies flat
// round batches of (row, doc) pairs in sequenced order.
struct Session {
  std::vector<Doc> docs;
};

}  // namespace

extern "C" {

void* merge_session_create(int64_t n_docs) {
  auto* s = new Session();
  s->docs.resize(static_cast<size_t>(n_docs));
  for (auto& d : s->docs) d.segs.reserve(64);
  return s;
}

void merge_session_destroy(void* h) {
  delete static_cast<Session*>(h);
}

// rows: [n_rows][12] int32 (OP_FIELDS order), doc_of_row: [n_rows].
// Rows must arrive in sequenced order per document (the round batch).
void merge_session_apply(void* h, const int32_t* rows,
                         const int32_t* doc_of_row, int64_t n_rows) {
  auto* s = static_cast<Session*>(h);
  for (int64_t i = 0; i < n_rows; ++i)
    s->docs[static_cast<size_t>(doc_of_row[i])]
        .apply(rows + i * kFields);
}

void merge_session_stats(void* h, int64_t doc,
                         uint64_t* out_checksum, int64_t* out_live) {
  auto* s = static_cast<Session*>(h);
  const Doc& d = s->docs[static_cast<size_t>(doc)];
  if (out_checksum) *out_checksum = d.checksum();
  int64_t live = 0;
  for (const Seg& seg : d.segs)
    if (seg.removed_seq == kNotRemoved) live += seg.length;
  if (out_live) *out_live = live;
}

// Live non-marker segments as (op_id, op_off, length) triples for
// host-side text reconstruction (host_bridge.extract_text shape).
// Returns the number of triples; writes at most `cap`.
int64_t merge_session_segs(void* h, int64_t doc, int32_t* out,
                           int64_t cap) {
  auto* s = static_cast<Session*>(h);
  const Doc& d = s->docs[static_cast<size_t>(doc)];
  int64_t n = 0;
  for (const Seg& seg : d.segs) {
    if (seg.removed_seq != kNotRemoved || seg.is_marker) continue;
    if (n < cap) {
      out[n * 3 + 0] = seg.op_id;
      out[n * 3 + 1] = seg.op_off;
      out[n * 3 + 2] = seg.length;
    }
    ++n;
  }
  return n;
}

// Replay one document's op stream `reps` times from scratch; returns
// nanoseconds-free op count actually applied (reps * n_ops) and the
// final checksum of the last replay via out params. Timing is done by
// the caller around this call.
void merge_replay(const int32_t* ops, int64_t n_ops, int64_t reps,
                  uint64_t* out_checksum, int64_t* out_live_chars) {
  uint64_t checksum = 0;
  int64_t live = 0;
  for (int64_t r = 0; r < reps; ++r) {
    Doc doc;
    doc.segs.reserve(256);
    for (int64_t i = 0; i < n_ops; ++i) doc.apply(ops + i * kFields);
    checksum = doc.checksum();
    live = 0;
    for (const Seg& s : doc.segs)
      if (s.removed_seq == kNotRemoved) live += s.length;
  }
  if (out_checksum) *out_checksum = checksum;
  if (out_live_chars) *out_live_chars = live;
}

}  // extern "C"
