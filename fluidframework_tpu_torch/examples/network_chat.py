"""Networked collaboration: the runnable dev service + socket driver
end to end in one process (the collaborative-textarea sample over
tinylicious).

Run: python -m fluidframework_tpu_torch.examples.network_chat
"""
import asyncio
import sys
import threading
import time

from fluidframework_tpu_torch.drivers.socket_driver import (
    SocketDocumentService,
)
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.service.ingress import AlfredServer


def main() -> int:
    server = AlfredServer()
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        await server.start()
        started.set()
        await server.serve_forever()

    threading.Thread(
        target=lambda: loop.run_until_complete(run()), daemon=True
    ).start()
    assert started.wait(10)
    print(f"dev service on 127.0.0.1:{server.port} "
          "(same protocol as python -m fluidframework_tpu_torch.service)")

    svc_a = SocketDocumentService("127.0.0.1", server.port, "chat")
    with svc_a.lock:
        alice = Container.load(svc_a, client_id="alice")
        log_a = (alice.runtime.create_datastore("room")
                 .create_channel("sharedstring", "log"))
        alice.flush()
        log_a.insert_text(0, "alice: hello over TCP\n")
        alice.flush()

    svc_b = SocketDocumentService("127.0.0.1", server.port, "chat")
    with svc_b.lock:
        bob = Container.load(svc_b, client_id="bob")
        log_b = bob.runtime.get_datastore("room").get_channel("log")
        log_b.insert_text(len(log_b.get_text()),
                          "bob: hi, got your message\n")
        bob.flush()

    deadline = time.time() + 10
    while time.time() < deadline:
        with svc_a.lock:
            if "bob:" in log_a.get_text():
                break
        time.sleep(0.05)
    with svc_a.lock, svc_b.lock:
        transcript = log_a.get_text()
        assert transcript == log_b.get_text()
    print(transcript.rstrip())
    with svc_a.lock:
        alice.close()
    with svc_b.lock:
        bob.close()
    svc_a.close()
    svc_b.close()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
