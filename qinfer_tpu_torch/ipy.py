"""Progress bars (counterpart of :mod:`qinfer_tpu.ipy`) with the
``start(max) / update(n) / finished()`` protocol that
:func:`~qinfer_tpu_torch.perf_testing.perf_test_multiple` drives: a
notebook widget when ipywidgets is there, else a text bar."""

from __future__ import annotations

import sys

__all__ = ["IPythonProgressBar", "TextProgressBar"]


class TextProgressBar:
    """A text progress bar on a stream (stderr by default)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self.max = None
        self.n = 0

    def start(self, max=100):
        self.max = max
        self.n = 0

    def update(self, n=None):
        self.n = self.n + 1 if n is None else n
        if self.max:
            frac = self.n / self.max
            self.stream.write(
                f"\r[{int(50 * frac) * '#':<50}] {self.n}/{self.max}")
            self.stream.flush()

    def finished(self):
        self.stream.write("\n")
        self.stream.flush()


class IPythonProgressBar:
    """An ipywidgets progress bar with the same protocol; a
    :class:`TextProgressBar` where ipywidgets cannot be imported."""

    def __init__(self):
        try:
            import ipywidgets
            from IPython.display import display

            self.widget = ipywidgets.FloatProgress(value=0.0, min=0.0,
                                                   max=100.0)
            self._display = display
            self._fallback = None
        except Exception:
            self.widget = None
            self._fallback = TextProgressBar()

    @property
    def description(self):
        return self.widget.description if self.widget is not None else ""

    @description.setter
    def description(self, value):
        if self.widget is not None:
            self.widget.description = value

    def start(self, max=100):
        if self.widget is not None:
            self.widget.max = max
            self._display(self.widget)
        else:
            self._fallback.start(max)

    def update(self, n=None):
        if self.widget is not None:
            self.widget.value = n if n is not None else self.widget.value + 1
        else:
            self._fallback.update(n)

    def finished(self):
        if self.widget is not None:
            self.widget.bar_style = "success"
        else:
            self._fallback.finished()
