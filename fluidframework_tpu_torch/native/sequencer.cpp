// Native sequencer core: the deli ticket() hot loop in C++.
//
// Reference semantics: server/routerlicious/packages/lambdas/src/deli/
// lambda.ts — ticket() (:741) assigns sequenceNumber, validates
// clientSequenceNumber continuity, tracks per-client refSeq, and stamps
// minimumSequenceNumber = min over connected clients' refSeqs (:308,
// clientSeqManager.ts). This is the service plane's hottest loop: one
// call per op per document. The Python DocumentSequencer
// (service/sequencer.py) is the spec oracle; differential tests pin
// this implementation to it op-for-op.
//
// Interface is C (ctypes-friendly): integer client ids (the Python
// wrapper interns strings), batch ticketing for throughput.

#include <cstdint>
#include <map>
#include <set>
#include <vector>

namespace {

struct ClientState {
    int64_t ref_seq;
    int64_t csn;
};

struct Sequencer {
    int64_t seq;
    int64_t msn;
    std::map<int64_t, ClientState> clients;
    // multiset of live refSeqs for O(log n) min maintenance
    std::multiset<int64_t> ref_seqs;

    int64_t compute_msn() {
        int64_t m = ref_seqs.empty() ? seq : *ref_seqs.begin();
        if (m > msn) msn = m;  // msn never regresses
        return msn;
    }
};

}  // namespace

// Ticket status codes (mirror TicketResult/Nack reasons)
enum TicketStatus : int32_t {
    TICKET_OK = 0,
    TICKET_UNKNOWN_CLIENT = 1,   // nack: join first
    TICKET_DUPLICATE = 2,        // dropped silently (idempotence)
    TICKET_CSN_GAP = 3,          // nack: clientSequenceNumber gap
    TICKET_REFSEQ_BELOW_MSN = 4, // nack: refSeq below msn
    TICKET_REFSEQ_AHEAD = 5,     // nack: refSeq ahead of doc seq
};

extern "C" {

void* seq_create(int64_t sequence_number, int64_t minimum_sequence_number) {
    auto* s = new Sequencer();
    s->seq = sequence_number;
    s->msn = minimum_sequence_number;
    return s;
}

void seq_destroy(void* handle) {
    delete static_cast<Sequencer*>(handle);
}

// Join: new client's refSeq starts at the join op's seq. Returns the
// join's sequence number. Redundant joins keep existing state.
int64_t seq_client_join(void* handle, int64_t client_id) {
    auto* s = static_cast<Sequencer*>(handle);
    int64_t join_seq = ++s->seq;
    auto it = s->clients.find(client_id);
    if (it == s->clients.end()) {
        // refSeq starts at the seq BEFORE the join: the client has
        // not seen its own join yet (matches service/sequencer.py)
        s->clients[client_id] = ClientState{join_seq - 1, 0};
        s->ref_seqs.insert(join_seq - 1);
    }
    s->compute_msn();
    return join_seq;
}

// Leave: returns the leave's sequence number, or -1 if unknown.
int64_t seq_client_leave(void* handle, int64_t client_id) {
    auto* s = static_cast<Sequencer*>(handle);
    auto it = s->clients.find(client_id);
    if (it == s->clients.end()) return -1;
    s->ref_seqs.erase(s->ref_seqs.find(it->second.ref_seq));
    s->clients.erase(it);
    int64_t leave_seq = ++s->seq;
    s->compute_msn();
    return leave_seq;
}

int64_t seq_sequence_number(void* handle) {
    return static_cast<Sequencer*>(handle)->seq;
}

// Allocate a seq for a service-generated system op (scribe's
// summaryAck/Nack loop back through the sequencer).
int64_t seq_bump(void* handle) {
    auto* s = static_cast<Sequencer*>(handle);
    int64_t v = ++s->seq;
    s->compute_msn();
    return v;
}

int64_t seq_minimum_sequence_number(void* handle) {
    return static_cast<Sequencer*>(handle)->msn;
}

int64_t seq_client_count(void* handle) {
    return static_cast<int64_t>(
        static_cast<Sequencer*>(handle)->clients.size());
}

// The hot loop: ticket n ops. Inputs are parallel arrays; outputs:
// out_seq/out_msn (valid when out_status==TICKET_OK) and out_status.
// Returns the count of TICKET_OK ops.
int64_t seq_ticket_batch(
    void* handle, int64_t n,
    const int64_t* client_ids, const int64_t* csns,
    const int64_t* ref_seqs,
    int64_t* out_seq, int64_t* out_msn, int32_t* out_status) {
    auto* s = static_cast<Sequencer*>(handle);
    int64_t ok = 0;
    for (int64_t i = 0; i < n; ++i) {
        auto it = s->clients.find(client_ids[i]);
        if (it == s->clients.end()) {
            out_status[i] = TICKET_UNKNOWN_CLIENT;
            continue;
        }
        ClientState& c = it->second;
        const int64_t expected = c.csn + 1;
        if (csns[i] < expected) {
            out_status[i] = TICKET_DUPLICATE;
            continue;
        }
        if (csns[i] > expected) {
            out_status[i] = TICKET_CSN_GAP;
            continue;
        }
        if (ref_seqs[i] < s->msn) {
            out_status[i] = TICKET_REFSEQ_BELOW_MSN;
            continue;
        }
        if (ref_seqs[i] > s->seq) {
            out_status[i] = TICKET_REFSEQ_AHEAD;
            continue;
        }
        c.csn = csns[i];
        if (ref_seqs[i] != c.ref_seq) {
            s->ref_seqs.erase(s->ref_seqs.find(c.ref_seq));
            c.ref_seq = ref_seqs[i];
            s->ref_seqs.insert(c.ref_seq);
        }
        out_seq[i] = ++s->seq;
        out_msn[i] = s->compute_msn();
        out_status[i] = TICKET_OK;
        ++ok;
    }
    return ok;
}

// Multi-document boxcar: ticket every document's op slice in ONE
// call — the Kafka boxcar shape (the deli lambda consumes message
// boxes grouped by document; lambdas/src/deli/lambda.ts rebatches the
// same way). Op arrays are flattened with doc_start[d]..doc_start[d+1]
// delimiting document d's slice. Returns total TICKET_OK count.
int64_t seq_ticket_multi(
    void** handles, int64_t n_docs, const int64_t* doc_start,
    const int64_t* client_ids, const int64_t* csns,
    const int64_t* ref_seqs,
    int64_t* out_seq, int64_t* out_msn, int32_t* out_status) {
    int64_t ok = 0;
    for (int64_t d = 0; d < n_docs; ++d) {
        const int64_t a = doc_start[d], b = doc_start[d + 1];
        if (b <= a) continue;
        ok += seq_ticket_batch(
            handles[d], b - a, client_ids + a, csns + a, ref_seqs + a,
            out_seq + a, out_msn + a, out_status + a);
    }
    return ok;
}

// Checkpoint export: fill parallel arrays (capacity must be
// >= seq_client_count). Returns the client count written.
int64_t seq_export_clients(
    void* handle, int64_t capacity,
    int64_t* client_ids, int64_t* ref_seqs_out, int64_t* csns) {
    auto* s = static_cast<Sequencer*>(handle);
    int64_t i = 0;
    for (const auto& [cid, state] : s->clients) {
        if (i >= capacity) break;
        client_ids[i] = cid;
        ref_seqs_out[i] = state.ref_seq;
        csns[i] = state.csn;
        ++i;
    }
    return i;
}

// Checkpoint restore: register a client with explicit state.
void seq_restore_client(void* handle, int64_t client_id,
                        int64_t ref_seq, int64_t csn) {
    auto* s = static_cast<Sequencer*>(handle);
    auto it = s->clients.find(client_id);
    if (it != s->clients.end()) {
        s->ref_seqs.erase(s->ref_seqs.find(it->second.ref_seq));
    }
    s->clients[client_id] = ClientState{ref_seq, csn};
    s->ref_seqs.insert(ref_seq);
}

}  // extern "C"
