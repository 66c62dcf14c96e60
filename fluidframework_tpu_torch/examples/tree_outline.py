"""Structured outline document: SharedTree with stored schema,
transactions, anchors and the editable surface (the tree-structured
document samples, e.g. examples/data-objects/webflow).

Run: python -m fluidframework_tpu_torch.examples.tree_outline
"""
import sys

from fluidframework_tpu_torch.drivers import LocalDocumentServiceFactory
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.models.tree import (
    FieldSchema,
    NodeSchema,
    SchemaViolation,
    StoredSchema,
    node,
)
from fluidframework_tpu_torch.service.local_server import LocalServer


def main() -> int:
    server = LocalServer()
    factory = LocalDocumentServiceFactory(server)
    a = Container.load(factory.create_document_service("outline"),
                       client_id="a")
    tree_a = (a.runtime.create_datastore("doc")
              .create_channel("sharedtree", "outline"))
    a.flush()

    # build via the typed editable surface
    root = tree_a.editable()
    root.field("sections").insert(0, [
        node("section", value="Intro"),
        node("section", value="Design"),
    ])
    sections = root.field("sections")
    sections[1].field("bullets").append([
        node("bullet", value="SoA segment tables"),
        node("bullet", value="doc-parallel mesh"),
    ])
    a.flush()

    # adopt a schema; from now on every client validates edits
    schema = StoredSchema(
        nodes={
            "section": NodeSchema("section", value="string", fields={
                "bullets": FieldSchema("sequence",
                                       allowed_types=("bullet",)),
            }),
            "bullet": NodeSchema("bullet", value="string"),
        },
        root_fields={"sections": FieldSchema(
            "sequence", allowed_types=("section",))},
    )
    tree_a.set_stored_schema(schema)
    a.flush()
    try:
        tree_a.insert_nodes(("sections",), 0, [node("rogue")])
        raise AssertionError("schema should have rejected this")
    except SchemaViolation as e:
        print(f"schema rejected: {e}")

    # anchor survives sibling edits; transaction commits atomically
    design = sections[1].anchor()
    with tree_a.transaction():
        sections.insert(0, [node("section", value="Abstract")])
        sections[0].field("bullets").append(
            [node("bullet", value="tl;dr")])
    a.flush()
    loc = tree_a.locate_anchor(design)
    print(f"'Design' slid to index {loc[-1]}")
    assert tree_a.get_field(("sections",))[loc[-1]]["value"] == "Design"

    b = Container.load(factory.create_document_service("outline"),
                       client_id="b")
    tree_b = b.runtime.get_datastore("doc").get_channel("outline")
    for i, section in enumerate(tree_b.editable().field("sections")):
        print(f"{i + 1}. {section.value}")
        for bullet in section.field("bullets"):
            print(f"   - {bullet.value}")
    assert tree_b.stored_schema is not None
    assert tree_a.signature() == tree_b.signature()
    a.close()
    b.close()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
