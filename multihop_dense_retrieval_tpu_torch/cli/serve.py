"""CLI: HTTP serving endpoint for multi-hop QA.

The port of the JAX package's ``cli/serve.py``: a stdlib HTTP server
exposing

  POST /answer     {"question": "..."}            → answer + chains + sp
  POST /retrieve   {"question": "...", "topk": k} → ranked chains only
  POST /add_doc    {"title": "...", "text": "..."} → live corpus add
  POST /delete_doc {"doc_id": i}                   → live swap-delete
  GET  /healthz                                    → liveness + model info

Concurrency model: requests are accepted on a thread pool
(ThreadingHTTPServer) but ALL engine work runs on ONE EngineWorker thread.
Concurrent questions are micro-batched into a single 2-hop search + reader
pass (the engine is batched; `answer_batch` pads the search to the
micro-batch cap), and live corpus updates are serialized against searches
on the same thread — updates write the device buffers in place, so nothing
may search while they run.  An engine error fails the requests of its
batch or op only.  The scaling unit is one server per GPU behind an
external balancer.  It runs on CUDA unless ``--device`` names another
device.

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.serve INDEX_DIR \
      --port 8080 --tokenizer hash --retriever-model tiny \
      --reader-model tiny --max-batch 16 --batch-wait-ms 8
"""

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)

from .demo import DemoPipeline


class EngineWorker(threading.Thread):
    """Single engine thread: micro-batches question ops, serializes updates.

    Ops: ("answer", {"question"}), ("add", {"title","text"}),
    ("delete", {"doc_id"}).  A question op opens a batching window of
    `batch_wait_ms` (or until `max_batch` items); an update op arriving
    mid-window flushes the batch first, preserving arrival order across
    op kinds.
    """

    def __init__(self, pipe, max_batch: int = 16, batch_wait_ms: float = 8.0):
        super().__init__(daemon=True, name="engine-worker")
        self.pipe = pipe
        self.q = queue.Queue()
        self.max_batch = max(1, max_batch)
        self.max_wait = batch_wait_ms / 1e3
        self.batches_run = 0
        self.questions_run = 0

    def submit(self, kind: str, payload: dict) -> Future:
        f = Future()
        self.q.put((kind, payload, f))
        return f

    def stop(self, timeout: float = 60.0):
        """End the thread once the ops queued before this call have run."""
        self.q.put(None)
        self.join(timeout)

    # ---- internals -----------------------------------------------------

    BATCHABLE = ("answer", "retrieve")

    def _run_batch(self, kind, batch):
        qs = [p["question"] for p, _ in batch]
        fn = (self.pipe.answer_batch if kind == "answer"
              else self.pipe.retrieve_batch)
        try:
            outs = fn(qs, pad_to=self.max_batch)
            for (_, f), out in zip(batch, outs):
                f.set_result(out)
        except Exception as e:  # noqa: BLE001 — surfaced per request
            for _, f in batch:
                f.set_exception(e)
        self.batches_run += 1
        self.questions_run += len(batch)

    def _run_op(self, kind, payload, f):
        try:
            # n_docs read HERE (single worker thread, right after the op) —
            # the handler thread reading it later would race other updates
            if kind == "add":
                doc_id = self.pipe.add_document(payload.get("title", ""),
                                                payload.get("text", ""))
                f.set_result({"doc_id": doc_id,
                              "n_docs": self.pipe.searcher.index.n_docs})
            elif kind == "delete":
                moved = self.pipe.delete_document(int(payload["doc_id"]))
                f.set_result({"moved_doc_id": moved,
                              "n_docs": self.pipe.searcher.index.n_docs})
            elif kind == "stats":
                # /healthz rides the worker too: reading n_docs from a
                # handler thread would race the in-place updates the whole
                # file exists to serialize
                f.set_result({"n_docs": self.pipe.searcher.index.n_docs})
            else:
                raise ValueError(f"unknown op {kind}")
        except Exception as e:  # noqa: BLE001
            f.set_exception(e)

    def run(self):
        pending = None
        while True:
            item = pending if pending is not None else self.q.get()
            pending = None
            if item is None:
                return
            kind, payload, f = item
            if kind not in self.BATCHABLE:
                self._run_op(kind, payload, f)
                continue
            batch = [(payload, f)]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is not None and nxt[0] == kind:
                    batch.append((nxt[1], nxt[2]))
                else:
                    # different kind (update OR other batchable op): flush
                    # this batch first, then serve the queued item
                    pending = nxt
                    break
            self._run_batch(kind, batch)


def make_handler(pipe: DemoPipeline, worker: EngineWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass  # quiet

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                stats = worker.submit("stats", {}).result()
                self._send(200, {
                    "status": "ok",
                    "n_docs": stats["n_docs"],
                    "queue_depth": worker.q.qsize(),
                    "batches_run": worker.batches_run,
                    "questions_run": worker.questions_run,
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._send(400, {"error": "invalid JSON body"})
                return
            if not isinstance(req, dict):
                self._send(400, {"error": "body must be a JSON object"})
                return
            try:
                self._dispatch(req)
            except (IndexError, ValueError) as e:
                # bad doc ids and malformed fields surface as client errors
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — a dropped connection
                self._send(500, {"error": str(e)})  # helps no client

        def _dispatch(self, req):
            # path FIRST: an unknown endpoint is a 404 regardless of body
            # (field validation before routing sent 400 "missing X" for
            # typo'd paths)
            if self.path not in ("/add_doc", "/delete_doc", "/answer",
                                 "/retrieve"):
                self._send(404, {"error": "not found"})
                return
            if self.path == "/add_doc":
                if not str(req.get("title", "")).strip():
                    self._send(400, {"error": "missing 'title'"})
                    return
                self._send(200, worker.submit("add", req).result())
                return
            if self.path == "/delete_doc":
                if "doc_id" not in req:
                    self._send(400, {"error": "missing 'doc_id'"})
                    return
                self._send(200, worker.submit("delete", req).result())
                return
            question = str(req.get("question", "")).strip()
            if not question:
                self._send(400, {"error": "missing 'question'"})
                return
            if self.path == "/answer":
                self._send(200, worker.submit(
                    "answer", {"question": question}).result())
            else:                       # /retrieve
                # retrieval-only micro-batches: no reader pass.  The chain
                # count is fixed by the engine (SearchConfig.topk); a
                # smaller per-request "topk" slices the ranked list, a
                # larger one is capped and reported.
                out = dict(worker.submit(
                    "retrieve", {"question": question}).result())
                if "topk" in req:
                    want = int(req["topk"])
                    if want < 1:
                        self._send(400, {"error": "'topk' must be >= 1"})
                        return
                    if want < len(out["chains"]):
                        out["chains"] = out["chains"][:want]
                    elif want > len(out["chains"]):
                        out["topk_capped"] = len(out["chains"])
                self._send(200, out)

    return Handler


# socketserver's default listen backlog is 5 connections: a burst of
# concurrent clients past it is reset by the kernel before the handler
# threads ever see it
BACKLOG = 128


class _ThreadingServer(ThreadingHTTPServer):
    request_queue_size = BACKLOG


class _Server(HTTPServer):
    request_queue_size = BACKLOG


def make_server(pipe: DemoPipeline, host: str, port: int, *,
                max_batch: int = 16, batch_wait_ms: float = 8.0,
                threaded: bool = True):
    """Start the EngineWorker and return a ready (not yet serving) server
    that queues up to BACKLOG connections."""
    worker = EngineWorker(pipe, max_batch=max_batch,
                          batch_wait_ms=batch_wait_ms)
    worker.start()
    cls = _ThreadingServer if threaded else _Server
    srv = cls((host, port), make_handler(pipe, worker))
    srv.engine_worker = worker
    return srv


def parse_args(argv=None):
    from . import common

    p = argparse.ArgumentParser()
    common.add_pipeline_args(p)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=16,
                   help="micro-batch cap for concurrent questions")
    p.add_argument("--batch-wait-ms", type=float, default=8.0,
                   help="batching window after the first queued question")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    pipe = DemoPipeline(args)
    server = make_server(pipe, args.host, args.port,
                         max_batch=args.max_batch,
                         batch_wait_ms=args.batch_wait_ms)
    print(f"serving on http://{args.host}:{args.port} "
          f"(POST /answer, /retrieve, /add_doc, /delete_doc; GET /healthz; "
          f"micro-batch {args.max_batch} x {args.batch_wait_ms}ms)")
    server.serve_forever()


if __name__ == "__main__":
    main()
