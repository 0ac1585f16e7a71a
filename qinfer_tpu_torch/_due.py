"""Citation hooks (counterpart of :mod:`qinfer_tpu._due`): ``due``,
``Doi`` and ``BibTeX`` from duecredit when it is installed, else no-op
stand-ins, so citation annotations never break an import."""

__all__ = ["due", "Doi", "BibTeX"]


class _InactiveDueCreditCollector:
    """A collector with duecredit's API that records nothing."""

    def _donothing(self, *args, **kwargs):
        return None

    def dcite(self, *args, **kwargs):
        def decorator(func):
            return func

        return decorator

    cite = load = add = _donothing

    def __repr__(self):
        return f"{self.__class__.__name__}()"


def _donothing_func(*args, **kwargs):
    return None


try:
    from duecredit import due, Doi, BibTeX  # type: ignore # noqa: F401
except ImportError:
    due = _InactiveDueCreditCollector()
    Doi = _donothing_func
    BibTeX = _donothing_func
