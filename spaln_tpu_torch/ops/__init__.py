from .params import DpParams, DpFlags
from .dp_spliced_ref import forward_spliced_ref, traceback_spliced_ref
