"""Threaded live sources: webcam index, RTSP / RTMP / HTTP(S) streams and
`.streams` lists (`sodt_tpu/data/streams.py`).

One daemon thread per stream keeps only the LATEST decoded frame
(dropping stale ones), and the iterator returns the current frame of
every stream; frames come back as raw uint8 HWC RGB, letterboxed
downstream on the device (`models.infer.Predictor`).

cv2 is imported when a source is made, never with this module; without
it a source raises, with JAX's `RuntimeError` text. The card's machine
has no cv2, so there streams raise exactly as JAX's code does.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path


def is_stream_source(source: str) -> bool:
    """Webcam index, URL schemes, or a .streams list file."""
    s = str(source)
    return (s.isdigit()
            or s.lower().startswith(("rtsp://", "rtmp://", "http://",
                                     "https://"))
            or s.endswith(".streams"))


class StreamSource:
    """Latest-frame readers over N streams.

    Iterating yields (names, [frame_u8_rgb, ...]); a frame may repeat if
    the producer has not delivered a new one yet (live semantics). Closed
    streams drop out; iteration stops when every stream has ended.
    """

    def __init__(self, source: str, max_fps: float = 30.0):
        try:
            import cv2
        except Exception as e:
            raise RuntimeError("stream sources need OpenCV (cv2)") from e
        self._cv2 = cv2
        if str(source).endswith(".streams"):
            sources = [ln.strip() for ln in Path(source).read_text().split()
                       if ln.strip()]
        else:
            sources = [str(source)]
        self.names = sources
        self.caps = []
        self.frames: list = [None] * len(sources)
        self.alive = [True] * len(sources)
        self._min_dt = 1.0 / max_fps
        self._threads = []
        self._stop = threading.Event()
        for i, s in enumerate(sources):
            cap = cv2.VideoCapture(int(s) if s.isdigit() else s)
            if not cap.isOpened():
                raise RuntimeError(f"failed to open stream {s!r}")
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError(f"failed to read from stream {s!r}")
            self.frames[i] = frame[..., ::-1].copy()  # BGR -> RGB
            self.caps.append(cap)
            t = threading.Thread(target=self._reader, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self, i: int):
        cap = self.caps[i]
        while not self._stop.is_set():
            ok, frame = cap.read()
            if not ok:
                self.alive[i] = False
                return
            self.frames[i] = frame[..., ::-1].copy()
            time.sleep(self._min_dt)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set() or not any(self.alive):
            raise StopIteration
        return list(self.names), [f for f in self.frames]

    def __len__(self):
        return len(self.names)

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        for cap in self.caps:
            cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
