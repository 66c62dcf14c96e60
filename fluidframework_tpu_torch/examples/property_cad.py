"""Schema-typed property-tree collaboration with Materialized History
publishing — the PropertyDDS sample (reference:
experimental/PropertyDDS example apps + the moira lambda pipeline).

Two engineers edit a typed parts tree (SharedPropertyTree: schemas,
squashed working changesets, commit()); every committed changeset is
published by the Moira lambda as a commit on the channel's branch in a
Materialized History service running in ANOTHER PROCESS, and the
branch's commit graph is read back over TCP.

Run: python -m fluidframework_tpu_torch.examples.property_cad
"""
import os
import re
import subprocess
import sys

from fluidframework_tpu_torch.service.moira import (
    MaterializedHistoryClient,
    MoiraLambda,
    derived_guid,
)
from fluidframework_tpu_torch.testing.runtime_mocks import (
    ContainerSession,
)

PART = {
    "typeid": "demo:part-1.0.0",
    "properties": [
        {"id": "x", "typeid": "Float64"},
        {"id": "y", "typeid": "Float64"},
        {"id": "label", "typeid": "String"},
    ],
}


def main() -> int:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    mh = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.moira",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo,
    )
    line = mh.stdout.readline()
    port = int(re.search(r":(\d+)", line).group(1))
    try:
        # collaborative session with a moira tap on the stream
        s = ContainerSession(["ana", "ben"])
        log = []
        orig = s._broadcast
        s._broadcast = lambda m: (log.append(m), orig(m))[1]
        for cid in ("ana", "ben"):
            s.runtime(cid).create_datastore("cad").create_channel(
                "sharedpropertytree", "parts")
            t = s.runtime(cid).get_datastore("cad").get_channel(
                "parts")
            t.schemas.register(PART)
        s.process_all()
        ana = s.runtime("ana").get_datastore("cad").get_channel(
            "parts")
        ben = s.runtime("ben").get_datastore("cad").get_channel(
            "parts")

        ana.insert_property("base", "demo:part-1.0.0")
        ana.set_value("base.label", "baseplate")
        ana.commit()
        s.process_all()
        ben.insert_property("arm", "demo:part-1.0.0")
        ben.set_value("arm.x", 12.5)
        ben.commit()
        s.process_all()
        ana.set_value("arm.y", -3.25)   # edit ben's part
        ana.commit()
        s.process_all()
        assert ana.signature() == ben.signature()
        print(f"converged parts: base={ana.get_value('base.label')!r}"
              f" arm=({ana.get_value('arm.x')}, "
              f"{ana.get_value('arm.y')})")

        # publish the sequenced changesets to the MH process
        client = MaterializedHistoryClient("127.0.0.1", port)
        lam = MoiraLambda(client, "cad-doc")
        for i, msg in enumerate(log):
            lam.handler(msg, offset=i)
        n = lam.flush()
        branch = derived_guid("cad-doc", "cad/parts")
        state = client.get_branch(branch)
        print(f"moira published {n} commits on branch "
              f"{branch[:13]}…")
        parent = state["rootCommitGuid"]
        for c in state["commits"]:
            assert c["parentGuid"] == parent  # linear history
            parent = c["guid"]
            meta = c["meta"]
            print(f"  commit {c['guid'][:8]} seq="
                  f"{meta['sequenceNumber']} "
                  f"msn={meta['minimumSequenceNumber']}")
        assert n == 3 and len(state["commits"]) == 3
        client.close()
        print("OK: property tree converged and its history is "
              "queryable from the Materialized History service.")
        return 0
    finally:
        mh.kill()
        mh.wait()


if __name__ == "__main__":
    raise SystemExit(main())
