"""Flowed-document binding over SharedString — the webflow-class
integration layer.

Reference: examples/data-objects/webflow/src/document/index.ts — the
reference's richest editor sample: a FLOWED document where block
structure (paragraphs, line breaks) and inline structure (nested
begin/end tag ranges) are all merge-tree MARKERS riding the same
sequenced string as the text, formatting is css-class token lists
applied as annotates, and removal keeps begin/end tag PAIRS consistent
(removing a begin tag removes its paired end tag and vice versa —
index.ts:248-270's remove walk). Next to ``richtext.py`` (the
prosemirror-class binding) this adds the marker-pair machinery and a
much annotate/marker-heavier op mix, which is exactly what VERDICT r4
next #9 wants as a second kernel workload generator.

Model:

- text: flat SharedString characters;
- blocks: ``MARKER_PARAGRAPH`` / ``MARKER_LINEBREAK`` markers
  (tileLabels paragraph/lineBreak, index.ts:154-156);
- inline tag ranges: ``MARKER_TAG_BEGIN``/``MARKER_TAG_END`` marker
  PAIRS sharing a ``pairId`` prop, begin carrying ``tag`` (em/strong/
  span/h1...); ranges nest (index.ts:158 rangeLabels beginTags);
- css classes: the ``class`` annotate prop holds a space-joined token
  list; add/remove reads each covered span's current tokens and
  annotates the updated list (util/tokenlist.ts semantics over
  annotate LWW);
- comments: an interval collection, endpoints slide with the text.

``remove()`` preserves pair consistency the way the reference does:
after removing the range, begin tags whose partner survived outside
the range (and vice versa) get their orphaned partner removed too —
each as its own sequenced op, so replicas converge by merge-tree
semantics alone.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Optional

# paragraph markers are a WIRE contract both bindings read off the
# same SharedString — one definition (richtext owns it)
from .richtext import MARKER_PARAGRAPH  # noqa: F401 (re-exported)

MARKER_LINEBREAK = 101
MARKER_TAG_BEGIN = 102
MARKER_TAG_END = 103

# the four kernel property channels this binding owns (DocStream
# intern_prop raises past PROP_CHANNELS=4: tag, pairId, class, heading)
PROP_TAG = "tag"
PROP_PAIR = "pairId"
PROP_CLASS = "class"
PROP_HEADING = "heading"

TAGS = ("em", "strong", "code", "span", "h1", "h2")


# ----------------------------------------------------------------------
# pair machinery shared by the binding and the bench-corpus stream
# generator (testing.record_flow_stream) — ONE copy of the
# index.ts:248 orphan-cleanup walk


def marker_positions(span_content, length: int, ref_type: int,
                     pair_id) -> list[int]:
    """Positions of pair markers with ``pair_id`` in the visible doc.
    ``span_content(a, b)`` is mergetree.span_content."""
    out, acc = [], 0
    for item in span_content(0, length):
        if item[0] == "text":
            acc += len(item[1])
            continue
        _, rt, props = item
        if rt == ref_type and (props or {}).get(PROP_PAIR) == pair_id:
            out.append(acc)
        acc += 1
    return out


def pair_consistent_remove(span_content, remove_fn,
                           start: int, end: int) -> None:
    """Remove [start, end), then remove tag partners the removal
    orphaned (index.ts:248-270): a begin whose end died keeps no
    range open; an end whose begin died closes nothing. Each removal
    is its own sequenced op, so replicas converge by merge-tree
    semantics alone. ``length`` is re-derived per pass by walking the
    visible content (positions shift after every removal)."""
    removed_begins: list = []
    removed_ends: list = []
    for item in span_content(start, end):
        if item[0] != "marker":
            continue
        _, rt, props = item
        pid = (props or {}).get(PROP_PAIR)
        if pid is None:
            continue
        if rt == MARKER_TAG_BEGIN:
            removed_begins.append(pid)
        elif rt == MARKER_TAG_END:
            removed_ends.append(pid)
    remove_fn(start, end)
    # span_content clamps its end bound itself, so the whole-doc scans
    # just pass a sentinel instead of recomputing the length per pass
    for pid in removed_begins:
        for pos in marker_positions(
                span_content, 1 << 30, MARKER_TAG_END, pid):
            remove_fn(pos, pos + 1)
    for pid in removed_ends:
        for pos in marker_positions(
                span_content, 1 << 30, MARKER_TAG_BEGIN, pid):
            remove_fn(pos, pos + 1)


@dataclass
class FlowBlock:
    """One rendered block: paragraph/lineBreak boundary + runs of
    (text, open-tag tuple, css-class frozenset)."""

    kind: str                      # "p" | "br"
    heading: Optional[int] = None
    runs: list = field(default_factory=list)

    @property
    def text(self) -> str:
        return "".join(t for t, _, _ in self.runs)


class FlowDocument:
    """One user's flowed-document session over a shared string."""

    def __init__(self, string, user: str = "user"):
        self.string = string
        self.user = user

    # ------------------------------------------------------------------

    @property
    def length(self) -> int:
        return self.string.get_length()

    def _items(self, start=0, end=None):
        if end is None:
            end = self.length
        return self.string.client.mergetree.span_content(start, end)

    def insert_text(self, pos: int, text: str,
                    classes: Optional[set] = None) -> None:
        props = {PROP_CLASS: " ".join(sorted(classes))} \
            if classes else None
        self.string.insert_text(pos, text, props)

    def insert_paragraph(self, pos: int,
                         heading: Optional[int] = None) -> None:
        props = {PROP_HEADING: heading} if heading else None
        self.string.insert_marker(pos, MARKER_PARAGRAPH, props)

    def insert_line_break(self, pos: int) -> None:
        self.string.insert_marker(pos, MARKER_LINEBREAK)

    def insert_tags(self, start: int, end: int, tag: str) -> str:
        """Wrap [start, end) in a begin/end tag pair (index.ts:309
        insertTags): two markers sharing a pairId; the end marker goes
        in first so the begin insert doesn't shift its position."""
        assert tag in TAGS, tag
        # uuid, not a process-local counter: two processes editing the
        # same doc as the same user must never mint colliding pairIds
        # (partner matching is by pairId alone — intervals.py uses the
        # same scheme for interval ids)
        pair_id = uuid.uuid4().hex
        self.string.insert_marker(
            end, MARKER_TAG_END, {PROP_PAIR: pair_id})
        self.string.insert_marker(
            start, MARKER_TAG_BEGIN,
            {PROP_TAG: tag, PROP_PAIR: pair_id})
        return pair_id

    # ------------------------------------------------------------------
    # pair-consistent removal (index.ts:248-270)

    def remove(self, start: int, end: int) -> None:
        """Remove [start, end); then remove tag partners orphaned by
        it — a begin whose end died keeps no range open, an end whose
        begin died closes nothing. (Shared walk: the bench corpus
        generator drives the SAME algorithm at the merge level —
        ``pair_consistent_remove``.)"""
        pair_consistent_remove(
            self.string.client.mergetree.span_content,
            self.string.remove_text, start, end,
        )

    # ------------------------------------------------------------------
    # css class token lists (util/tokenlist.ts over annotate LWW)

    def add_css_class(self, start: int, end: int, *tokens: str) -> None:
        self._update_classes(start, end, set(tokens), set())

    def remove_css_class(self, start: int, end: int,
                         *tokens: str) -> None:
        self._update_classes(start, end, set(), set(tokens))

    def _update_classes(self, start: int, end: int,
                        add: set, drop: set) -> None:
        spans = self.string.client.mergetree.span_props(
            start, end, [PROP_CLASS]
        )
        for lo, hi, old in spans:
            have = set((old[PROP_CLASS] or "").split()) \
                if old[PROP_CLASS] else set()
            new = (have | add) - drop
            if new == have:
                continue
            self.string.annotate_range(
                lo, hi,
                {PROP_CLASS: " ".join(sorted(new)) or None},
            )

    # ------------------------------------------------------------------
    # comments (interval collection)

    def add_comment(self, start: int, end: int, text: str):
        """Anchor a comment to DOC positions [start, end) — end
        EXCLUSIVE like every range op here. Interval anchors attach to
        characters, so the END anchor is the LAST covered position
        (end-1); ``comments()`` therefore reports inclusive endpoints
        and callers quote with ``text_span(start, end + 1)``."""
        comments = self.string.get_interval_collection("comments")
        end_anchor = max(start, min(end - 1, max(self.length - 1, 0)))
        return comments.add(start, end_anchor, props={
            "author": self.user, "text": text,
        })

    def comments(self) -> list[dict]:
        comments = self.string.get_interval_collection("comments")
        out = []
        for iv in comments:
            lo, hi = comments.endpoints(iv)
            if lo < 0:
                continue
            out.append({"id": iv.interval_id, "start": lo,
                        "end": hi, **dict(iv.props or {})})
        return sorted(out, key=lambda c: (c["start"], c["id"]))

    # ------------------------------------------------------------------
    # view model

    def render(self) -> list[FlowBlock]:
        """Blocks with (text, open tags, classes) runs; unmatched tag
        markers (concurrent-removal orphans) are skipped exactly like
        the reference's renderer ignores unpaired tags."""
        # pass 1: which pairIds have BOTH markers visible
        begins, ends = set(), set()
        for item in self._items():
            if item[0] != "marker":
                continue
            _, rt, props = item
            pid = (props or {}).get(PROP_PAIR)
            if rt == MARKER_TAG_BEGIN:
                begins.add(pid)
            elif rt == MARKER_TAG_END:
                ends.add(pid)
        paired = begins & ends
        # per-POSITION class sets (text and markers both occupy one
        # position, so span_props offsets line up with the walk)
        classes_at: list[frozenset] = []
        for lo, hi, old in self.string.client.mergetree.span_props(
                0, self.length, [PROP_CLASS]):
            tok = frozenset((old[PROP_CLASS] or "").split())
            classes_at.extend([tok] * (hi - lo))
        blocks = [FlowBlock(kind="p")]
        open_tags: list[tuple] = []  # (pairId, tag)
        acc = 0
        for item in self._items():
            if item[0] == "text":
                text = item[1]
                tags = tuple(t for _, t in open_tags)
                # split the run wherever the class set changes
                j = 0
                while j < len(text):
                    tok = classes_at[acc + j]
                    k = j + 1
                    while k < len(text) \
                            and classes_at[acc + k] == tok:
                        k += 1
                    blocks[-1].runs.append((text[j:k], tags, tok))
                    j = k
                acc += len(text)
                continue
            _, rt, props = item
            props = props or {}
            if rt == MARKER_PARAGRAPH:
                blocks.append(FlowBlock(
                    kind="p", heading=props.get(PROP_HEADING)))
            elif rt == MARKER_LINEBREAK:
                blocks.append(FlowBlock(kind="br"))
            elif rt == MARKER_TAG_BEGIN:
                if props.get(PROP_PAIR) in paired:
                    open_tags.append(
                        (props.get(PROP_PAIR), props.get(PROP_TAG)))
            elif rt == MARKER_TAG_END:
                pid = props.get(PROP_PAIR)
                open_tags = [t for t in open_tags if t[0] != pid]
            acc += 1
        return blocks

    def plain_text(self) -> str:
        return "".join(
            item[1] for item in self._items() if item[0] == "text"
        )

    def doc_pos(self, text_index: int) -> int:
        """Map a plain-text index to a DOC position (markers occupy
        positions; richtext.py:304 has the same mapping)."""
        acc = 0
        for item in self._items():
            if item[0] == "text":
                if text_index < len(item[1]):
                    return acc + text_index
                text_index -= len(item[1])
                acc += len(item[1])
            else:
                acc += 1
        return acc

    def text_span(self, start: int, end: int) -> str:
        """Text characters within DOC positions [start, end)."""
        return "".join(
            item[1] for item in self._items(start, end)
            if item[0] == "text"
        )

    def signature(self):
        return self.string.signature()


# ----------------------------------------------------------------------
# workload generator (the second kernel stress source)


def flow_workload(doc: FlowDocument, rng, steps: int) -> None:
    """Webflow-mix driver: typing plus MUCH heavier marker and
    annotate pressure than the prosemirror mix — tag-pair inserts,
    removes that cross pair boundaries, css token-list churn, comment
    intervals, block splits."""
    words = ("flow", "tensor", "lattice", "quorum", "spline", "glyph")
    for _ in range(steps):
        roll = rng.random()
        n = doc.length
        if roll < 0.30 or n < 4:
            pos = rng.randint(0, n)
            classes = {rng.choice(("hero", "note"))} \
                if rng.random() < 0.3 else None
            doc.insert_text(pos, rng.choice(words) + " ", classes)
        elif roll < 0.45:
            a = rng.randrange(n - 2)
            b = rng.randint(a + 1, min(n, a + 9))
            doc.insert_tags(a, b, rng.choice(TAGS))
        elif roll < 0.60:
            a = rng.randrange(n - 2)
            b = rng.randint(a + 1, min(n, a + 7))
            doc.remove(a, b)  # may cross tag pairs: partner cleanup
        elif roll < 0.80:
            a = rng.randrange(n - 2)
            b = rng.randint(a + 1, min(n, a + 10))
            if rng.random() < 0.6:
                doc.add_css_class(a, b, rng.choice(
                    ("hot", "cold", "muted", "alert")))
            else:
                doc.remove_css_class(a, b, rng.choice(
                    ("hot", "cold", "muted", "alert")))
        elif roll < 0.90:
            pos = rng.randint(0, n)
            if rng.random() < 0.5:
                doc.insert_paragraph(
                    pos, heading=rng.choice((None, 1, 2)))
            else:
                doc.insert_line_break(pos)
        else:
            a = rng.randrange(n - 2)
            doc.add_comment(a, rng.randint(a + 1, min(n, a + 6)),
                            f"c{rng.randrange(99)}")
