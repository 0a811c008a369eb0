"""Host time of the bank builds (a wavelet's bank; a stream's halo and
bank), per call, in ms: the program's ``ninw.bank.build`` spans in the
traced window."""
from ..spans import ms_per_call


def read(run):
    return ms_per_call(run, "ninw.bank.build")
