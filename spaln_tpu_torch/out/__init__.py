from .formats import gff3_lines, exon_table_lines, intron_lines, sam_line
