"""Rich-text editor binding over SharedString — the prosemirror-class
integration layer.

Reference: examples/data-objects/prosemirror (and webflow/monaco) —
the reference's editor samples prove the DDS surface carries a real
editor: a document model richer than a flat string (paragraphs,
styled runs), LOCAL editor state that survives remote edits (cursor /
selection mapped through concurrent inserts and removes), formatting
as annotations, comments as interval collections, and reconnect
without losing anything. This module is that binding rebuilt for the
TPU repo's SharedString, plus a deterministic workload generator so
the same surface doubles as a merge-kernel stress source (VERDICT r3
next-round #10).

Model (what a view layer consumes):

- the document is a flat SharedString; PARAGRAPH boundaries are
  markers (``MARKER_PARAGRAPH``) carrying block props (heading level);
- character formatting (bold/italic/comment-highlight) is annotate
  props on ranges — LWW per key, concurrency-safe by sequencing;
- the CURSOR and SELECTION are local reference positions
  (slide-on-remove), so remote edits move them exactly the way a
  prosemirror position mapping would;
- comments are interval-collection entries whose endpoints slide with
  the text (intervalCollection.ts semantics).

``render()`` produces ``[Paragraph(style, runs=[(text, marks)])]`` —
position-faithful, so a real view could diff it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..models.mergetree import ReferenceType

MARKER_PARAGRAPH = 100

# annotate keys the binding owns
MARK_KEYS = ("bold", "italic", "code")
HEADING_KEY = "heading"


@dataclass
class Paragraph:
    style: dict
    runs: list = field(default_factory=list)  # [(text, frozenset marks)]

    @property
    def text(self) -> str:
        return "".join(t for t, _ in self.runs)


class RichTextEditor:
    """One user's editor session over a shared string channel."""

    def __init__(self, string, user: Optional[str] = None):
        self.string = string
        self.user = user or "user"
        self._cursor_ref = None
        self._anchor_ref = None  # selection anchor (None = caret)
        self.marks: set[str] = set()  # active toggle marks for typing
        self.set_cursor(self.length)

    # ------------------------------------------------------------------
    # cursor / selection (local refs: stable through remote edits)

    @property
    def length(self) -> int:
        return self.string.get_length()

    def _make_ref(self, pos: int):
        """A position anchor. References attach to characters, so the
        end-of-document caret anchors AFTER the last character
        ((ref, bias=1)); an empty document has no anchor (None =
        document end)."""
        if self.length == 0:
            return None
        if pos >= self.length:
            return (self.string.create_position_reference(
                self.length - 1, ReferenceType.SLIDE_ON_REMOVE), 1)
        return (self.string.create_position_reference(
            pos, ReferenceType.SLIDE_ON_REMOVE), 0)

    def _ref_pos(self, ref) -> int:
        if ref is None:
            return self.length
        anchor, bias = ref
        pos = self.string.local_reference_position(anchor)
        if pos < 0:
            return self.length
        return min(pos + bias, self.length)

    @property
    def cursor(self) -> int:
        return self._ref_pos(self._cursor_ref)

    def set_cursor(self, pos: int, extend: bool = False) -> None:
        pos = max(0, min(pos, self.length))
        if extend and self._anchor_ref is None:
            self._anchor_ref = self._cursor_ref
        elif not extend:
            self._anchor_ref = None
        self._cursor_ref = self._make_ref(pos)

    @property
    def selection(self) -> tuple[int, int]:
        """(start, end) of the selection; collapsed => (cursor, cursor)."""
        c = self.cursor
        if self._anchor_ref is None:
            return c, c
        a = self._ref_pos(self._anchor_ref)
        return (min(a, c), max(a, c))

    # ------------------------------------------------------------------
    # editing commands

    def type_text(self, text: str) -> None:
        """Insert at the cursor (replacing any selection), applying
        the active toggle marks — prosemirror's storedMarks."""
        start, end = self.selection
        if end > start:
            self.string.remove_text(start, end)
        props = {k: True for k in self.marks} or None
        self.string.insert_text(start, text, props)
        self.set_cursor(start + len(text))

    def backspace(self) -> None:
        start, end = self.selection
        if end > start:
            self.string.remove_text(start, end)
            self.set_cursor(start)
        elif start > 0:
            self.string.remove_text(start - 1, start)
            self.set_cursor(start - 1)

    def split_paragraph(self, heading: Optional[int] = None) -> None:
        """Insert a paragraph boundary at the cursor (Enter)."""
        start, end = self.selection
        if end > start:
            self.string.remove_text(start, end)
        props = {HEADING_KEY: heading} if heading else None
        self.string.insert_marker(start, MARKER_PARAGRAPH, props)
        self.set_cursor(start + 1)

    def toggle_mark(self, mark: str) -> None:
        """Bold/italic/code over the selection; with a caret, toggles
        the stored mark for subsequent typing."""
        assert mark in MARK_KEYS, mark
        start, end = self.selection
        if end == start:
            if mark in self.marks:
                self.marks.discard(mark)
            else:
                self.marks.add(mark)
            return
        # turning_on considers TEXT positions only: a selection
        # spanning a paragraph marker must still clear a fully-marked
        # range (prosemirror's toggleMark ignores non-inline nodes)
        spans = self.string.client.mergetree.span_props(
            start, end, [mark]
        )
        texty = self._text_positions()
        turning_on = any(
            not old[mark] and any(texty[lo:hi])
            for lo, hi, old in spans
        )
        self.string.annotate_range(
            start, end, {mark: True if turning_on else None}
        )

    def set_heading(self, level: Optional[int]) -> None:
        """Set the heading level of the paragraph containing the
        cursor (annotates its leading marker; the document's first
        paragraph has no marker and stays body text)."""
        pos = self._paragraph_marker_before(self.cursor)
        if pos is None:
            return
        self.string.annotate_range(
            pos, pos + 1, {HEADING_KEY: level}
        )

    def add_comment(self, start: int, end: int, text: str):
        """Anchor a comment to [start, end): endpoints slide with
        concurrent edits (the interval collection). Endpoint anchors
        attach to characters; a comment reaching the document end
        anchors its end ON the last character with a +1 bias (same
        trick as the end-of-document caret), so the final character is
        never silently dropped from the range."""
        end_bias = 0
        if end >= self.length:
            end = max(self.length - 1, 0)
            end_bias = 1
        start = min(start, end)
        comments = self.string.get_interval_collection("comments")
        return comments.add(start, end, props={
            "author": self.user, "text": text,
            "endBias": end_bias,
        })

    def comments(self) -> list[dict]:
        out = []
        comments = self.string.get_interval_collection("comments")
        for iv in comments:
            lo, hi = comments.endpoints(iv)
            if lo < 0:
                continue  # both endpoints collapsed away
            props = dict(iv.props or {})
            hi += props.pop("endBias", 0)
            out.append({
                "id": iv.interval_id, "start": lo, "end": hi,
                **props,
            })
        return sorted(out, key=lambda c: (c["start"], c["id"]))

    # ------------------------------------------------------------------
    # view model

    def _paragraph_marker_before(self, pos: int) -> Optional[int]:
        items = self.string.client.mergetree.span_content(0, pos)
        acc = 0
        last = None
        for item in items:
            if item[0] == "text":
                acc += len(item[1])
            else:
                if item[1] == MARKER_PARAGRAPH:
                    last = acc
                acc += 1
        return last

    def render(self) -> list[Paragraph]:
        """Paragraph list with styled runs — the editor view model."""
        items = self.string.client.mergetree.span_content(
            0, self.length
        )
        paras = [Paragraph(style={})]
        for item in items:
            if item[0] == "marker":
                _, ref_type, props = item
                if ref_type == MARKER_PARAGRAPH:
                    style = {}
                    if props and props.get(HEADING_KEY):
                        style["heading"] = props[HEADING_KEY]
                    paras.append(Paragraph(style=style))
                continue
            # text runs carry uniform props per segment; re-read the
            # marks from span_props at run granularity
            paras[-1].runs.append((item[1], frozenset()))
        # second pass: stamp marks by position
        flat_marks = self._marks_by_position()
        pos = 0
        for p in paras:
            if p is not paras[0]:
                pos += 1  # the paragraph marker occupies one position
            new_runs: list = []
            for text, _ in p.runs:
                for ch in text:
                    m = flat_marks[pos]
                    if new_runs and new_runs[-1][1] == m:
                        new_runs[-1][0] += ch
                    else:
                        new_runs.append([ch, m])
                    pos += 1
            p.runs = [(t, m) for t, m in new_runs]
        return paras

    def _text_positions(self) -> list[bool]:
        """True at document positions holding text (False = marker)."""
        out: list[bool] = []
        for item in self.string.client.mergetree.span_content(
                0, self.length):
            if item[0] == "text":
                out.extend([True] * len(item[1]))
            else:
                out.append(False)
        return out

    def _marks_by_position(self) -> list[frozenset]:
        spans = self.string.client.mergetree.span_props(
            0, self.length, list(MARK_KEYS)
        )
        out = [frozenset()] * self.length
        for lo, hi, props in spans:
            m = frozenset(k for k in MARK_KEYS if props.get(k))
            for i in range(lo, hi):
                out[i] = m
        return out

    def plain_text(self) -> str:
        return self.string.get_text()

    def text_span(self, start: int, end: int) -> str:
        """Text content of a document-position range (markers occupy
        a position but contribute no text) — e.g. the quoted text of
        a comment's interval."""
        return "".join(
            item[1]
            for item in self.string.client.mergetree.span_content(
                start, end)
            if item[0] == "text"
        )

    def doc_pos(self, text_index: int) -> int:
        """Map an index into ``plain_text()`` (which excludes markers)
        to a document position (which counts each marker as one) —
        what ``set_cursor``/``add_comment`` expect. The editor-binding
        equivalent of prosemirror's position mapping between the DOM
        text and the document."""
        items = self.string.client.mergetree.span_content(
            0, self.length
        )
        doc = 0
        text = 0
        for item in items:
            if item[0] == "marker":
                doc += 1
                continue
            if text + len(item[1]) > text_index:
                return doc + (text_index - text)
            text += len(item[1])
            doc += len(item[1])
        return doc


# ----------------------------------------------------------------------
# deterministic workload generator (doubles as merge-kernel stress)


def editor_workload(editor: RichTextEditor, rng, steps: int) -> None:
    """Drive one editor with a realistic mix: typing bursts, bursty
    backspacing, formatting, paragraph splits, comments — the op
    pattern the merge kernel's config2 wants more of (same-client
    chains, concurrent storms, annotate ranges)."""
    words = ("collab", "merge", "tensor", "ink", "quorum", "ledger")
    for _ in range(steps):
        roll = rng.random()
        n = editor.length
        if roll < 0.45 or n == 0:
            editor.set_cursor(rng.randint(0, n))
            burst = rng.randint(1, 3)
            for _ in range(burst):
                editor.type_text(rng.choice(words) + " ")
        elif roll < 0.6:
            editor.set_cursor(rng.randint(0, n))
            for _ in range(rng.randint(1, 4)):
                editor.backspace()
        elif roll < 0.75 and n > 2:
            a = rng.randint(0, n - 2)
            editor.set_cursor(a)
            editor.set_cursor(
                rng.randint(a + 1, min(n, a + 12)), extend=True
            )
            editor.toggle_mark(rng.choice(MARK_KEYS))
            editor.set_cursor(editor.selection[1])
        elif roll < 0.85:
            editor.set_cursor(rng.randint(0, n))
            editor.split_paragraph(
                heading=rng.choice((None, 1, 2)))
        elif roll < 0.95 and n > 2:
            a = rng.randint(0, n - 2)
            editor.add_comment(
                a, rng.randint(a + 1, min(n, a + 8)),
                f"note-{rng.randint(0, 99)}",
            )
        else:
            editor.set_heading(rng.choice((None, 1, 2, 3)))
