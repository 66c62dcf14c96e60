"""Rich-text collaborative editor over the TCP service — the
prosemirror-class sample (reference:
examples/data-objects/prosemirror): two live editor sessions with
paragraphs, headings, bold/italic runs, sliding comments, stable
cursors through remote edits, and a reconnect mid-session.

Run: python -m fluidframework_tpu_torch.examples.richtext_editor
(starts its own service subprocess on a free port)
"""
import os
import re
import signal
import subprocess
import sys
import time

from fluidframework_tpu_torch.drivers.socket_driver import (
    SocketDocumentService,
)
from fluidframework_tpu_torch.framework.richtext import (
    RichTextEditor,
)
from fluidframework_tpu_torch.loader import Container


def show(title, editor):
    print(f"--- {title} ---")
    for p in editor.render():
        head = f"h{p.style['heading']} " if p.style.get("heading") \
            else ""
        runs = " + ".join(
            f"{t!r}{sorted(m) if m else ''}" for t, m in p.runs
        )
        print(f"  {head}{runs or '(empty)'}")
    for c in editor.comments():
        quoted = editor.text_span(c["start"], c["end"])
        print(f"  [comment by {c['author']}: {c['text']!r} "
              f"on {quoted!r}]")


def pump(svc, container, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc.lock:
            if container.runtime.pending.count == 0:
                return
        time.sleep(0.02)
    raise TimeoutError("ops never acked")


def main() -> int:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    server = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo,
    )
    line = server.stdout.readline()
    port = int(re.search(r":(\d+)", line).group(1))
    try:
        svc_a = SocketDocumentService("127.0.0.1", port, "article")
        with svc_a.lock:
            ca = Container.load(svc_a, client_id="alice")
            sa = ca.runtime.create_datastore("app").create_channel(
                "sharedstring", "body")
            ca.flush()
            alice = RichTextEditor(sa, "alice")
            alice.type_text("Collaborative Editing")
            alice.split_paragraph()
            alice.type_text("Two people can write one document.")
            ca.flush()
        pump(svc_a, ca)

        svc_b = SocketDocumentService("127.0.0.1", port, "article")
        with svc_b.lock:
            cb = Container.load(svc_b, client_id="bob")
            sb = cb.runtime.get_datastore("app").get_channel("body")
            bob = RichTextEditor(sb, "bob")
            show("bob joins and sees", bob)

        # bob sets his caret mid-sentence; alice edits BEFORE it;
        # bob's caret slides, his typing lands where he intended
        with svc_b.lock:
            bob.set_cursor(bob.doc_pos(
                bob.plain_text().index("one document")))
        with svc_a.lock:
            alice.set_cursor(0)
            alice.type_text(">> ")
            ca.flush()
        pump(svc_a, ca)
        time.sleep(0.3)  # let the broadcast reach bob
        with svc_b.lock:
            bob.type_text("exactly ")
            cb.flush()
        pump(svc_b, cb)

        # formatting + a comment anchored to sliding text
        with svc_a.lock:
            text = alice.plain_text()
            i = alice.doc_pos(text.index("Collaborative"))
            alice.set_cursor(i)
            alice.set_cursor(i + len("Collaborative Editing"),
                             extend=True)
            alice.toggle_mark("bold")
            j = alice.doc_pos(text.index("Two people"))
            alice.set_cursor(j)
            alice.set_heading(1)
            k = alice.doc_pos(text.index("one document"))
            alice.add_comment(k, k + len("one document"),
                              "define 'document'?")
            ca.flush()
        pump(svc_a, ca)

        # reconnect: bob goes offline, keeps typing, comes back
        with svc_b.lock:
            cb.disconnect()
            bob.set_cursor(bob.length)
            bob.split_paragraph(heading=2)
            bob.type_text("Offline section")
            bob.set_cursor(bob.length - len("section"))
            bob.set_cursor(bob.length, extend=True)
            bob.toggle_mark("italic")
        with svc_a.lock:
            alice.set_cursor(alice.length)
            alice.type_text(" (alice kept going)")
            ca.flush()
        pump(svc_a, ca)
        with svc_b.lock:
            cb.connect()
            cb.flush()
        pump(svc_b, cb)
        time.sleep(0.5)
        with svc_a.lock:
            ca.flush()
        pump(svc_a, ca)
        time.sleep(0.5)

        with svc_a.lock, svc_b.lock:
            ta, tb = alice.plain_text(), bob.plain_text()
            assert ta == tb, (ta, tb)
            assert [p.runs for p in alice.render()] == \
                [p.runs for p in bob.render()]
            assert alice.comments() == bob.comments()
            show("converged document (both editors identical)", alice)
        print("OK: rich-text session converged over the TCP "
              "service, including a reconnect.")
        with svc_a.lock:
            ca.close()
        with svc_b.lock:
            cb.close()
        svc_a.close()
        svc_b.close()
        return 0
    finally:
        os.kill(server.pid, signal.SIGKILL)
        server.wait()


if __name__ == "__main__":
    raise SystemExit(main())
