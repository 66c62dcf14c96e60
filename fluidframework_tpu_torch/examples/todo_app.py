"""Todo app: SharedMap of items + undo/redo (the todo sample,
examples/data-objects/todo).

Run: python -m fluidframework_tpu_torch.examples.todo_app
"""
import sys

from fluidframework_tpu_torch.drivers import LocalDocumentServiceFactory
from fluidframework_tpu_torch.framework.undo_redo import (
    SharedMapUndoRedoHandler,
    UndoRedoStackManager,
)
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.service.local_server import LocalServer


def main() -> int:
    server = LocalServer()
    factory = LocalDocumentServiceFactory(server)
    app = Container.load(factory.create_document_service("todos"),
                         client_id="app")
    ds = app.runtime.create_datastore("todo")
    items = ds.create_channel("sharedmap", "items")
    app.flush()

    undo = UndoRedoStackManager()
    SharedMapUndoRedoHandler(undo, items)

    items.set("1", {"title": "write the framework", "done": True})
    items.set("2", {"title": "beat the baseline", "done": False})
    items.set("3", {"title": "ship examples", "done": False})
    app.flush()

    # a collaborator marks one done
    peer = Container.load(factory.create_document_service("todos"),
                          client_id="peer")
    peer_items = peer.runtime.get_datastore("todo").get_channel("items")
    entry = dict(peer_items.get("3"))
    entry["done"] = True
    peer_items.set("3", entry)
    peer.flush()

    for key in sorted(items.keys()):
        item = items.get(key)
        mark = "x" if item["done"] else " "
        print(f"[{mark}] {item['title']}")
    assert items.get("3")["done"] is True

    # undo the last local change on the app client
    undo.close_current_operation()
    items.set("2", {"title": "beat the baseline", "done": True})
    app.flush()
    undo.undo_operation()
    app.flush()
    assert items.get("2")["done"] is False
    print("undo restored item 2")
    app.close()
    peer.close()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
