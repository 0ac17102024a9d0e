from .codec import (encode_dna, encode_protein, decode_dna, decode_protein,
                    comrev, complement, translate, nuc2tron, decode_tron)
from .fasta import read_fasta, iter_fasta, SeqRecord, write_fasta
from .genome import GenomeStore
