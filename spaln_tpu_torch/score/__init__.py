from .simmtx import (dna_matrix, mdm_matrix, text_matrix, tron_matrix,
                     Simmtx, DEF_NPRM, DEF_PPRM)
from .tables import TableDir, find_table_dir
from .pssm import PSSM, load_pssm, scan_pssm
from .intron import IntronPenalty, IldParams
from .splice import SpliceSignals, build_splice_signals
