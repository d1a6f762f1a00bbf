"""Real-time spoken-dialogue-system (SDS) loop.

Counterpart of ``voiceactivityprojection_tpu/inference/sds.py`` (reference:
sds/run_sds.py:31-273): take stereo audio in hops of ``chunk_time``, run
the model incrementally over a rolling context (``StreamingVap``, or
``KVStreamingVap`` under ``transformer_mode="kv"``), smooth speaker A's
``p_now`` over the last ``prob_smooth_time`` and publish it over ZMQ PUB
(topic ``tt_probs``). ``zmq_subscriber`` mirrors sds/zmk_receiver.py:11-23.

Audio comes from an ``AudioSource``: ``WavSource`` (a file, for tests and
headless runs; ``ops/audio.py`` ``load_waveform``) or ``MicSource``
(pyaudio). ``pyaudio`` and ``zmq`` are imported only inside the classes
that use them, as in JAX (:64, :90).
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional

import numpy as np

from voiceactivityprojection_tpu_torch.config import SDSConfig
from voiceactivityprojection_tpu_torch.inference.streaming import SAMPLES_PER_FRAME, StreamingVap


class AudioSource:
    """Yields (2, chunk_samples) float32 stereo chunks."""

    def chunks(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class WavSource(AudioSource):
    """Plays a WAV file as a stream of fixed chunks (a mono file gets a
    silent second channel); ``realtime`` paces it at the sample rate."""

    def __init__(self, path: str, chunk_samples: int, realtime: bool = False, sample_rate: int = 16_000):
        from voiceactivityprojection_tpu_torch.ops.audio import load_waveform, mono_to_stereo

        x, _ = load_waveform(path, sample_rate=sample_rate)
        self.x = mono_to_stereo(x[None])[0]  # (2, n)
        self.chunk_samples = chunk_samples
        self.realtime = realtime
        self.sample_rate = sample_rate

    def chunks(self) -> Iterator[np.ndarray]:
        n = self.x.shape[-1]
        for i in range(0, n - self.chunk_samples + 1, self.chunk_samples):
            if self.realtime:
                time.sleep(self.chunk_samples / self.sample_rate)
            yield self.x[:, i: i + self.chunk_samples]


class MicSource(AudioSource):
    """pyaudio stereo capture, 16-bit (contract of sds/run_sds.py:100-160)."""

    def __init__(self, chunk_samples: int, sample_rate: int = 16_000, device: int = -1):
        import pyaudio  # only where a microphone is used

        self.pa = pyaudio.PyAudio()
        kwargs = {} if device < 0 else {"input_device_index": device}
        self.stream = self.pa.open(
            format=pyaudio.paInt16, channels=2, rate=sample_rate,
            input=True, frames_per_buffer=chunk_samples, **kwargs,
        )
        self.chunk_samples = chunk_samples

    def chunks(self) -> Iterator[np.ndarray]:
        while True:
            raw = self.stream.read(self.chunk_samples, exception_on_overflow=False)
            x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
            yield x.reshape(-1, 2).T  # de-interleave (sds/run_sds.py:206-212)

    def close(self) -> None:
        self.stream.stop_stream()
        self.stream.close()
        self.pa.terminate()


class ZmqPublisher:
    """PUB socket publishing "<topic> <float>" (sds/run_sds.py:249-251);
    port 0 binds a port the OS picks (``self.port``)."""

    def __init__(self, port: int = 5578, topic: str = "tt_probs"):
        import zmq

        self.ctx = zmq.Context()
        self.sock = self.ctx.socket(zmq.PUB)
        self.sock.bind(f"tcp://*:{port}")
        self.port = int(self.sock.getsockopt_string(zmq.LAST_ENDPOINT).rsplit(":", 1)[1])
        self.topic = topic

    def send(self, value: float) -> None:
        self.sock.send_string(f"{self.topic} {value}")

    def close(self) -> None:
        self.sock.close()
        self.ctx.term()


def zmq_subscriber(port: int = 5578, topic: str = "tt_probs", host: str = "localhost",
                   timeout_s: Optional[float] = None):
    """SUB socket generator of the published floats (contract of
    sds/zmk_receiver.py:11-23); with ``timeout_s`` a wait longer than that
    raises ``zmq.Again``. The socket closes when the generator does."""
    import zmq

    ctx = zmq.Context()
    sock = ctx.socket(zmq.SUB)
    sock.setsockopt(zmq.LINGER, 0)
    if timeout_s is not None:
        sock.setsockopt(zmq.RCVTIMEO, int(timeout_s * 1000))
    sock.connect(f"tcp://{host}:{port}")
    sock.setsockopt_string(zmq.SUBSCRIBE, topic)
    try:
        while True:
            _, val = sock.recv_string().split(" ", 1)
            yield float(val)
    finally:
        sock.close(0)
        ctx.term()


class WavRecorder:
    """Collects the captured stereo chunks and writes a 16-bit WAV on
    close (the reference records its capture, sds/run_sds.py:137-147)."""

    def __init__(self, path: str, sample_rate: int = 16_000):
        self.path = path
        self.sample_rate = sample_rate
        self.chunks: List[np.ndarray] = []

    def add(self, chunk: np.ndarray) -> None:
        self.chunks.append(np.asarray(chunk))

    def close(self) -> None:
        if not self.chunks:
            return
        import wave

        data = np.concatenate(self.chunks, axis=-1)  # (2, n)
        pcm = (np.clip(data.T, -1, 1) * 32767).astype(np.int16)
        with wave.open(self.path, "wb") as f:
            f.setnchannels(data.shape[0])
            f.setsampwidth(2)
            f.setframerate(self.sample_rate)
            f.writeframes(pcm.tobytes())


class TurnTakingSDS:
    """The streaming turn-taking loop (contract of sds/run_sds.py:162-263).
    ``model`` is a float32 ``VapModel`` (the streamers compute in float32)."""

    def __init__(
        self,
        model,
        conf: Optional[SDSConfig] = None,
        source: Optional[AudioSource] = None,
        publisher: Optional[ZmqPublisher] = None,
    ):
        self.conf = conf or SDSConfig()
        chunk_samples = int(self.conf.chunk_time * self.conf.sample_rate)
        if chunk_samples % SAMPLES_PER_FRAME:
            raise ValueError(
                f"chunk_time={self.conf.chunk_time} is not a whole number of "
                f"{SAMPLES_PER_FRAME}-sample (20 ms) frames; an external source honoring "
                "chunk_time would not match the streaming hop size"
            )
        hop_frames = max(chunk_samples // SAMPLES_PER_FRAME, 1)
        if self.conf.transformer_mode == "kv":
            from voiceactivityprojection_tpu_torch.inference.streaming_kv import KVStreamingVap

            self.stream = KVStreamingVap(model, context_time=self.conf.context_time, hop_frames=hop_frames)
        elif self.conf.transformer_mode == "window":
            self.stream = StreamingVap(model, context_time=self.conf.context_time, hop_frames=hop_frames)
        else:
            raise ValueError(
                f"transformer_mode must be 'window' or 'kv', got {self.conf.transformer_mode!r}"
            )
        # at least one frame: prob_smooth_time=0 means no smoothing, the
        # newest frame (0 would take the whole window in window mode and
        # keep an unbounded history in kv mode)
        self.smooth_frames = max(1, int(self.conf.prob_smooth_time * self.conf.frame_hz))
        # kv mode emits only the new frames of a hop: keep the smoothing
        # window's history
        self._p_history: List[float] = []
        self.source = source
        self.publisher = publisher
        self.recorder = WavRecorder(self.conf.savefile, self.conf.sample_rate) if self.conf.savefile else None

    def step(self, chunk: np.ndarray) -> float:
        """One hop: speaker A's p_now averaged over the last
        ``prob_smooth_time`` (sds/run_sds.py:242-243)."""
        out = self.stream.push(chunk)
        p_now = out["p_now"][:, 0].cpu().numpy()
        if self.conf.transformer_mode == "kv":
            self._p_history.extend(p_now.tolist())
            del self._p_history[: -self.smooth_frames]
            if not self._p_history:  # the encoder still priming: neutral
                return 0.5
            return float(np.mean(self._p_history))
        return float(p_now[-self.smooth_frames:].mean())

    def run(self, max_chunks: Optional[int] = None, log=print) -> None:
        source = self.source or MicSource(self.stream.hop_samples, self.conf.sample_rate, self.conf.audio_device)
        pub = self.publisher
        if pub is None and self.conf.zmq_port > 0:
            pub = ZmqPublisher(self.conf.zmq_port, self.conf.zmq_topic)
        self.stream.reset()
        self._p_history = []
        try:
            for i, chunk in enumerate(source.chunks()):
                if self.recorder is not None:
                    self.recorder.add(chunk)
                p = self.step(chunk)
                if pub is not None:
                    pub.send(p)
                if log is not None:
                    log(f"p_now(A)={p:.3f}")
                if max_chunks is not None and i + 1 >= max_chunks:
                    break
        finally:
            source.close()
            if pub is not None:
                pub.close()
            if self.recorder is not None:
                self.recorder.close()
