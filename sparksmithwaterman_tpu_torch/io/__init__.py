"""Input/output of the port: reads and reference parsing, directory
crawling and the result report."""

from sparksmithwaterman_tpu_torch.io.crawler import iter_files
from sparksmithwaterman_tpu_torch.io.fasta import get_reads, get_ref_seqs
from sparksmithwaterman_tpu_torch.io.report import build_report

__all__ = ["get_reads", "get_ref_seqs", "iter_files", "build_report"]
