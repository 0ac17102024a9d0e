from .wilip import find_hsps, chain_hsps, wilip, Hsp, Chain
