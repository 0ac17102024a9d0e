from .gene import GeneStructure, Exon, build_gene_structure
