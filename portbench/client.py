"""The load generator: a child process of the run, standard library only.

Protocol on its standard streams: it reads one JSON line (``port``,
``model``, ``mix``, ``seed``, ``vocab``, ``seconds``), builds the
schedule (``traffic.build``), prints ``ready``, reads ``go <t0>`` (the
traffic's start on ``time.time()``'s clock) and drives the server:
streamed ``POST /v1/completions`` with token-id prompts, ``temperature
0`` and ``ignore_eos``. No request is sent once the window has closed;
the server ends the streams still open when the grace ends, and
``cut_s`` later the client cuts whatever is left. It then prints
one JSON line: a record a request sent.

    python portbench/client.py   (started by the run, never by hand)
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import sys
import threading
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import traffic  # noqa: E402


class Driver:
    def __init__(self, port: int, model: str, sched: traffic.Schedule,
                 t0: float, t_close: float, t_end: float):
        self.port, self.model, self.sched = port, model, sched
        self.t0, self.t_close, self.t_end = t0, t_close, t_end
        self.records = []
        self.lock = threading.Lock()
        self.open_conns = set()
        self.cutting = False

    def send(self, req: traffic.Request, due=None) -> None:
        rec = {"rid": req.rid, "due": due, "send": time.time(),
               "first": None, "last": None, "events": 0, "status": None,
               "finish": None, "done": False, "error": None, "cut": False}
        with self.lock:
            self.records.append(rec)
        body = json.dumps({
            "model": self.model, "prompt": self.sched.prompt_ids(req),
            "max_tokens": req.max_tokens, "temperature": 0.0,
            "stream": True, "ignore_eos": True}).encode()
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=None)
        with self.lock:
            self.open_conns.add(conn)
        try:
            rec["send"] = time.time()
            conn.request("POST", "/v1/completions", body=body, headers={
                "Content-Type": "application/json", "X-Request-Id": req.rid})
            resp = conn.getresponse()
            rec["status"] = resp.status
            if resp.status != 200:
                rec["error"] = resp.read(512).decode(errors="replace")
                return
            while True:
                line = resp.readline()
                if not line:
                    break
                if not line.startswith(b"data: "):
                    continue
                now = time.time()
                if line.startswith(b"data: [DONE]"):
                    rec["done"] = True
                    break
                if rec["first"] is None:
                    rec["first"] = now
                rec["events"] += 1
                if b'"finish_reason": null' not in line:
                    choice = json.loads(line[6:])["choices"][0]
                    if choice.get("finish_reason") is not None:
                        rec["finish"] = choice["finish_reason"]
                        rec["last"] = now
        except Exception as exc:  # noqa: BLE001 - recorded as the failure
            if self.cutting:
                rec["cut"] = True
            else:
                rec["error"] = f"{type(exc).__name__}: {exc}"
        finally:
            with self.lock:
                self.open_conns.discard(conn)
            conn.close()

    def caller(self, reqs, start: float) -> None:
        wait(start)
        for req in reqs:
            if time.time() >= self.t_close:
                return
            self.send(req)
            if self.sched.think_s:
                wait(time.time() + self.sched.think_s)

    def run(self) -> None:
        threads = []
        if self.sched.loop == "closed":
            for c, reqs in sorted(self.sched.by_client().items()):
                th = threading.Thread(
                    target=self.caller,
                    args=(reqs, self.t0 + self.sched.starts[c]), daemon=True)
                th.start()
                threads.append(th)
        else:
            for req in self.sched.requests:
                due = self.t0 + req.due
                if due >= self.t_close:
                    break
                wait(due)
                th = threading.Thread(target=self.send, args=(req, due),
                                      daemon=True)
                th.start()
                threads.append(th)
        wait(self.t_end)
        self.cutting = True
        with self.lock:
            conns = list(self.open_conns)
        for conn in conns:
            sock = conn.sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        for th in threads:
            th.join(timeout=30)


def wait(t: float) -> None:
    while True:
        left = t - time.time()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


def main() -> int:
    cfg = json.loads(sys.stdin.readline())
    sched = traffic.build(cfg["mix"], cfg["seed"], cfg["vocab"],
                          cfg["seconds"])
    print("ready", flush=True)
    t0 = float(sys.stdin.readline().split()[1])
    mix = cfg["mix"]
    t_close = t0 + float(mix.get("ramp_s", 0)) + float(cfg["seconds"])
    t_end = t_close + float(mix.get("grace_s", 10)) + float(cfg["cut_s"])
    drv = Driver(cfg["port"], cfg["model"], sched, t0, t_close, t_end)
    drv.run()
    with drv.lock:
        records = list(drv.records)
    sys.stdout.write(json.dumps(records) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
