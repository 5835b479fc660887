"""Open-loop HTTP load generator, run as a child process of a serve run so
that it shares no interpreter lock with the server.

    python3 -m benchmark.loadgen < job

Reads one JSON job from standard input: `port`, `schedule` (a list of
[due seconds after the start, body index]), `bodies` (base64), `keep`
(request indices whose responses come back), `start_in` (seconds from
now to the first due time) and `wait_s` (how long past the last due time
to wait for answers). Each request is sent at its due time on a thread of
its own, whatever earlier requests are doing. Writes one JSON line: per
request [due, sent, done, status] in seconds from the start (null when
it never came back), the kept responses (base64), and the start `t0` on
the system's monotonic clock.
Imports only the standard library.
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import threading
import time


def main() -> int:
    job = json.loads(sys.stdin.read())
    bodies = [base64.b64decode(b) for b in job["bodies"]]
    keep = set(job["keep"])
    n = len(job["schedule"])
    rows = [None] * n
    kept = {}
    lock = threading.Lock()
    t0 = time.monotonic() + job["start_in"]

    def send(i, due, body):
        sent = time.monotonic() - t0
        status, data = None, b""
        try:
            conn = http.client.HTTPConnection("127.0.0.1", job["port"], timeout=job["wait_s"])
            conn.request("POST", "/v1/segment?format=npz", body=body,
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
            conn.close()
        except OSError:
            status = None
        done = time.monotonic() - t0
        with lock:
            rows[i] = [due, sent, done if status == 200 else None, status]
            if i in keep and status == 200:
                kept[str(i)] = base64.b64encode(data).decode()

    threads = []
    for i, (due, b) in enumerate(job["schedule"]):
        delay = t0 + due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=send, args=(i, due, bodies[b]), daemon=True)
        th.start()
        threads.append(th)
    deadline = t0 + job["schedule"][-1][0] + job["wait_s"]
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    with lock:
        out = {"rows": [r if r is not None else [job["schedule"][i][0], None, None, None]
                        for i, r in enumerate(rows)], "kept": dict(kept), "t0": t0}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
