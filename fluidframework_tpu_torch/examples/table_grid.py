"""Collaborative spreadsheet: SharedMatrix rows/cols/cells (the
table-document sample, examples/data-objects/table-document).

Run: python -m fluidframework_tpu_torch.examples.table_grid
"""
import sys

from fluidframework_tpu_torch.drivers import LocalDocumentServiceFactory
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.service.local_server import LocalServer


def main() -> int:
    server = LocalServer()
    factory = LocalDocumentServiceFactory(server)
    a = Container.load(factory.create_document_service("sheet"),
                       client_id="a")
    grid_a = (a.runtime.create_datastore("table")
              .create_channel("sharedmatrix", "grid"))
    a.flush()
    grid_a.insert_rows(0, 3)
    grid_a.insert_cols(0, 3)
    for r in range(3):
        for c in range(3):
            grid_a.set_cell(r, c, r * 3 + c)
    a.flush()

    b = Container.load(factory.create_document_service("sheet"),
                       client_id="b")
    grid_b = b.runtime.get_datastore("table").get_channel("grid")

    # concurrent structural edits: a inserts a row while b inserts a
    # column — permutation vectors merge them
    grid_a.insert_rows(1, 1)
    grid_b.insert_cols(0, 1)
    grid_b.set_cell(0, 0, "hdr")
    a.flush()
    b.flush()

    assert grid_a.row_count == grid_b.row_count == 4
    assert grid_a.col_count == grid_b.col_count == 4
    for r in range(grid_a.row_count):
        row = [grid_a.get_cell(r, c, default="·")
               for c in range(grid_a.col_count)]
        print(" | ".join(f"{v!s:>4}" for v in row))
        for c in range(grid_a.col_count):
            assert grid_a.get_cell(r, c) == grid_b.get_cell(r, c)
    a.close()
    b.close()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
