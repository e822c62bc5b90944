"""The HTTP API over the serving engine (counterpart of
geoguessr_ai_tpu/serving/api.py):

  GET  /                      service info
  GET  /health                liveness
  POST /submit_image/         upload 1 or 4 images, returns a submission id
  GET  /prediction/{id}       the prediction for a submission
  GET  /predicition/{id}      [sic] alias kept for reference clients
  GET  /model/{id}            model metadata
  GET  /image/{id}            echo a submitted image

The handlers are the methods of ``GuessApi``, a plain class that needs no
web framework; ``create_app`` wires them into FastAPI, an optional
dependency imported only there.  Concurrent predictions coalesce in one
``MicroBatcher``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional

#: Completed submissions kept; past it the oldest completed go first.
MAX_SUBMISSIONS = 1000
#: Hard cap: past it the oldest go, completed or not.
MAX_SUBMISSIONS_HARD = 2000


class ApiError(Exception):
    """A handler's refusal: an HTTP status and its detail."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class GuessApi:
    """Submission store and handlers.

    The engine (``ServingEngine(backbone=, checkpoint=, device=)`` unless
    one is given) and the MicroBatcher are built once, under one lock, at
    first use; the batcher's warmup of every bucket runs in a background
    thread (``warmup_thread``).  Each submission has its own lock, so two
    polls of one id run one device predict, while polls of different ids
    still coalesce in the batcher."""

    def __init__(self, engine=None, backbone: str = "tinyvit",
                 checkpoint: Optional[str] = None, device=None):
        self.backbone = backbone
        self.checkpoint = checkpoint
        self.device = device
        self._engine = engine
        self._batcher = None
        self.warmup_thread: Optional[threading.Thread] = None
        self.submissions: Dict[int, Dict] = {}
        self._counter = itertools.count(1)
        # re-entrant: get_batcher() builds the engine while holding it
        self._lock = threading.RLock()

    def get_engine(self):
        with self._lock:
            if self._engine is None:
                from geoguessr_ai_torch.serving.engine import ServingEngine

                self._engine = ServingEngine(backbone=self.backbone,
                                             checkpoint=self.checkpoint,
                                             device=self.device)
        return self._engine

    def get_batcher(self):
        with self._lock:
            if self._batcher is None:
                from geoguessr_ai_torch.serving.engine import MicroBatcher

                batcher = MicroBatcher(self.get_engine())
                self.warmup_thread = threading.Thread(target=batcher.warmup,
                                                      daemon=True)
                self.warmup_thread.start()
                self._batcher = batcher
        return self._batcher

    # -- handlers ----------------------------------------------------------

    def root(self) -> Dict:
        return {
            "service": "geoguessr-ai-torch",
            "model": self.backbone,
            "endpoints": ["/health", "/submit_image/", "/prediction/{id}",
                          "/model/{id}", "/image/{id}"],
        }

    def health(self) -> Dict:
        return {"status": "ok"}

    def model_info(self, model_id: str) -> Dict:
        eng = self.get_engine()
        return {"model_id": model_id, "backbone": self.backbone,
                "num_cells": eng.table.num_cells,
                "image_size": eng.image_size}

    def submit_image(self, blobs: List[bytes]) -> Dict:
        if len(blobs) not in (1, 4):
            raise ApiError(400, "submit exactly 1 or 4 images")
        with self._lock:
            sid = next(self._counter)
            self.submissions[sid] = {"blobs": list(blobs), "result": None,
                                     "lock": threading.Lock()}
            subs = self.submissions
            if len(subs) > MAX_SUBMISSIONS:
                done = [s for s, sub in subs.items()
                        if sub["result"] is not None]
                for old in done[: len(subs) - MAX_SUBMISSIONS]:
                    subs.pop(old)
            while len(subs) > MAX_SUBMISSIONS_HARD:
                subs.pop(next(iter(subs)))
        return {"submission_id": sid, "num_images": len(blobs)}

    def _submission(self, sid: int) -> Dict:
        sub = self.submissions.get(sid)
        if sub is None:
            raise ApiError(404, f"submission {sid} not found")
        return sub

    def prediction(self, sid: int) -> Dict:
        sub = self._submission(sid)
        with sub["lock"]:
            if sub["result"] is None:
                import numpy as np

                from geoguessr_ai_torch.data.pipeline import decode_jpeg

                size = self.get_engine().image_size
                views = np.zeros((4, size, size, 3), np.uint8)
                try:
                    for v, blob in enumerate(sub["blobs"][:4]):
                        views[v] = decode_jpeg(blob, size)
                except Exception as e:
                    raise ApiError(400, f"undecodable image: {e}") from e
                if len(sub["blobs"]) == 1:
                    views[1:] = views[0]
                r = self.get_batcher().predict(views)
                sub["blobs"] = sub["blobs"][:1]  # kept for /image/{id}
                sub["result"] = {
                    "lat": r.lat,
                    "lon": r.lon,
                    "top": [{"geocell_index": i, "prob": p, "country": c,
                             "admin1": a}
                            for i, p, c, a in zip(r.top_ids, r.top_probs,
                                                  r.top_countries,
                                                  r.top_admin1)],
                }
        return sub["result"]

    #: the reference's route name, typo included
    predicition = prediction

    def image(self, sid: int) -> bytes:
        return self._submission(sid)["blobs"][0]


def create_app(engine=None, backbone: str = "tinyvit",
               checkpoint: Optional[str] = None, device=None):
    """A FastAPI app serving ``GuessApi``'s handlers (``app.state.api``)."""
    try:
        from fastapi import FastAPI, File, HTTPException, UploadFile
        from fastapi.responses import Response
    except ImportError as e:
        raise RuntimeError(
            "fastapi is not installed; pip install 'geoguessr-ai-tpu[serving]'"
        ) from e

    api = GuessApi(engine, backbone, checkpoint, device)
    app = FastAPI(title="geoguessr-ai-torch", version="0.1.0")
    app.state.api = api
    app.state.get_batcher = api.get_batcher

    def call(handler, *args):
        try:
            return handler(*args)
        except ApiError as e:
            raise HTTPException(e.status, e.detail) from e

    app.get("/")(api.root)
    app.get("/health")(api.health)

    @app.get("/model/{model_id}")
    def model_info(model_id: str):
        return call(api.model_info, model_id)

    @app.post("/submit_image/")
    async def submit_image(files: List[UploadFile] = File(...)):
        if len(files) not in (1, 4):
            raise HTTPException(400, "submit exactly 1 or 4 images")
        return call(api.submit_image, [await f.read() for f in files])

    @app.get("/prediction/{sid}")
    def prediction(sid: int):
        return call(api.prediction, sid)

    @app.get("/predicition/{sid}")
    def predicition(sid: int):
        return call(api.predicition, sid)

    @app.get("/image/{sid}")
    def image(sid: int):
        return Response(content=call(api.image, sid), media_type="image/jpeg")

    return app


def main():  # pragma: no cover
    import uvicorn

    uvicorn.run(create_app(), host="0.0.0.0", port=8000)


if __name__ == "__main__":  # pragma: no cover
    main()
