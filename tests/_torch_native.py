"""Both packages' native audio loaders on one backend, for the port's
tests that compare audio with the JAX package at the same bytes.

The native resampler and scipy's agree to 1e-5, not bit for bit, so such a
test holds only when both packages in the process took the same backend.
The port's loader builds ``native/libvapaudio.so`` under a lock and renames
it into place; the JAX loader builds straight into the target and, when it
meets a half-written file another test worker is still linking, raises
``OSError`` once and then caches the failure for the rest of the process.
``same_native_backend`` builds through the port's loader first, resets such
a cached failure of the JAX loader (the library is whole by then) and
asserts that both report the same backend."""

import time

from voiceactivityprojection_tpu.utils import native as jnative
from voiceactivityprojection_tpu_torch.utils import native as tnative

RETRIES = 20


def same_native_backend(monkeypatch) -> bool:
    """Whether both packages run on the native library (else both on
    scipy); raises AssertionError when they cannot be brought to agree."""
    port = tnative.available()
    for attempt in range(RETRIES):
        if jnative._lib is None and jnative._tried:
            monkeypatch.setattr(jnative, "_tried", False)
        try:
            ours = jnative.available()
        except OSError:  # a file the JAX loader of another worker is still writing
            time.sleep(0.25)
            continue
        if ours == port:
            return port
        time.sleep(0.25)
    raise AssertionError(f"the native audio library loads in one package and not the other: "
                         f"port {port}, JAX {jnative._lib is not None}")
