"""Collaborative text editing: two live clients over the in-proc
service (the shared-text sample, examples/data-objects/shared-text).

Run: python -m fluidframework_tpu_torch.examples.collaborative_text
"""
import sys

from fluidframework_tpu_torch.drivers import LocalDocumentServiceFactory
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.service.local_server import LocalServer


def main() -> int:
    server = LocalServer()
    factory = LocalDocumentServiceFactory(server)

    alice = Container.load(factory.create_document_service("doc"),
                           client_id="alice")
    text_a = (alice.runtime.create_datastore("app")
              .create_channel("sharedstring", "story"))
    alice.flush()
    text_a.insert_text(0, "Collaboration works.")
    alice.flush()

    bob = Container.load(factory.create_document_service("doc"),
                         client_id="bob")
    text_b = bob.runtime.get_datastore("app").get_channel("story")
    print(f"bob loads: {text_b.get_text()!r}")

    # concurrent edits: both type before seeing each other
    text_a.insert_text(13, " really")
    text_b.annotate_range(0, 13, {"bold": True})
    text_b.insert_text(0, ">> ")
    alice.flush()
    bob.flush()

    assert text_a.get_text() == text_b.get_text()
    print(f"converged: {text_a.get_text()!r}")

    # interval collection: a comment anchored to a range slides with
    # edits (intervalCollection.ts semantics)
    comments = text_a.get_interval_collection("comments")
    interval = comments.add(3, 16)
    alice.flush()
    text_b.insert_text(0, "## ")
    bob.flush()
    start, end = comments.endpoints(interval)
    print(f"comment interval now at [{start}, {end}): "
          f"{text_a.get_text()[start:end]!r}")
    assert text_a.get_text()[start:end].startswith("Collaboration")

    alice.close()
    bob.close()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
