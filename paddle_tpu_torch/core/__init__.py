"""The port's core (``paddle_tpu/core``): dtypes (``dtype``), the
framework RNG (``random``), the public autograd API (``autograd``),
``to_tensor`` (``tensor``), and the host-side native pieces
(``native_build.py`` and ``native/``: C++ built with ``g++`` at first use,
never at import)."""
