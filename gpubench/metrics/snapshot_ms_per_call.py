"""Host time of the adapters' snapshots of the user's data (the float32
copy of ``get_data()``), per call, in ms: the program's
``ninw.adapter.snapshot`` spans in the traced window."""
from ..spans import ms_per_call


def read(run):
    return ms_per_call(run, "ninw.adapter.snapshot")
