"""Flowed-document editor over the TCP service — the webflow-class
sample (reference: examples/data-objects/webflow): two live sessions
editing one FLOWED document — nested inline tag ranges (em/strong as
paired markers), paragraphs and line breaks as tiles, css-class
token-list formatting, sliding comments — with a removal that crosses
a tag pair (the partner tag is cleaned up) and a disconnect/reconnect
mid-session.

Run: python -m fluidframework_tpu_torch.examples.webflow_editor
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
from fluidframework_tpu_torch.framework.flowdoc import (
    FlowDocument,
)
from fluidframework_tpu_torch.loader import Container


def show(title, doc):
    print(f"--- {title} ---")
    for b in doc.render():
        head = f"h{b.heading} " if b.heading else \
            ("~ " if b.kind == "br" else "")
        runs = " + ".join(
            f"{t!r}"
            + (f"<{'/'.join(tags)}>" if tags else "")
            + (f".{'.'.join(sorted(cls))}" if cls else "")
            for t, tags, cls in b.runs
        )
        print(f"  {head}{runs or '(empty)'}")
    for c in doc.comments():
        quoted = doc.text_span(c["start"], c["end"] + 1)
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
        svc_a = SocketDocumentService("127.0.0.1", port, "flowpage")
        with svc_a.lock:
            ca = Container.load(svc_a, client_id="alice")
            sa = ca.runtime.create_datastore("app").create_channel(
                "sharedstring", "body")
            ca.flush()
            alice = FlowDocument(sa, "alice")
            alice.insert_text(0, "Flowed documents nest inline "
                                 "ranges inside block tiles.")
            alice.insert_paragraph(0, heading=1)
            alice.insert_text(0, "Webflow sample")
            ca.flush()
        pump(svc_a, ca)

        svc_b = SocketDocumentService("127.0.0.1", port, "flowpage")
        with svc_b.lock:
            cb = Container.load(svc_b, client_id="bob")
            sb = cb.runtime.get_datastore("app").get_channel("body")
            bob = FlowDocument(sb, "bob")
            show("bob joins and sees", bob)

        # concurrent inline structure: alice emphasizes a span while
        # bob strongs a different one; both nest cleanly
        with svc_a.lock:
            i = alice.doc_pos(
                alice.plain_text().index("inline ranges"))
            alice.insert_tags(i, i + len("inline ranges"), "em")
            ca.flush()
        pump(svc_a, ca)
        time.sleep(0.3)
        with svc_b.lock:
            bob.insert_tags(bob.length - 1 - len("block tiles."),
                            bob.length - 1, "strong")
            bob.add_css_class(0, len("Webflow sample") + 1, "hero")
            cb.flush()
        pump(svc_b, cb)
        time.sleep(0.3)

        # a comment anchored to text that will slide
        with svc_a.lock:
            ca.flush()
            # comments take DOC positions (markers occupy positions):
            # map the plain-text index through doc_pos
            k = alice.doc_pos(alice.plain_text().index("block"))
            alice.add_comment(k, k + len("block"), "tiles = markers")
            alice.insert_text(0, ">> ")
            ca.flush()
        pump(svc_a, ca)
        time.sleep(0.3)

        # removal crossing a tag pair: bob deletes a range containing
        # an END tag marker; the orphaned BEGIN is cleaned up
        with svc_b.lock:
            cb.flush()
            bob.remove(bob.length - 3, bob.length)
            cb.flush()
        pump(svc_b, cb)
        time.sleep(0.3)

        # reconnect: alice goes offline, keeps editing, returns
        with svc_a.lock:
            ca.disconnect()
            alice.insert_line_break(alice.length)
            alice.insert_text(alice.length, "offline flow addendum")
            alice.add_css_class(alice.length - 8, alice.length,
                                "muted")
        with svc_b.lock:
            bob.insert_text(bob.length, " (bob kept going)")
            cb.flush()
        pump(svc_b, cb)
        with svc_a.lock:
            ca.connect()
            ca.flush()
        pump(svc_a, ca)
        time.sleep(0.5)
        with svc_b.lock:
            cb.flush()
        pump(svc_b, cb)
        time.sleep(0.5)

        with svc_a.lock, svc_b.lock:
            ta, tb = alice.plain_text(), bob.plain_text()
            assert ta == tb, (ta, tb)
            assert alice.signature() == bob.signature()
            assert [(b.kind, b.heading, b.runs)
                    for b in alice.render()] == \
                [(b.kind, b.heading, b.runs) for b in bob.render()]
            assert alice.comments() == bob.comments()
            show("converged flowed document (both sessions "
                 "identical)", alice)
        print("OK: webflow-class session converged over the TCP "
              "service, including a pair-crossing removal and a "
              "reconnect.")
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
