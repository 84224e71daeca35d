"""Parse: the host's share of the window spent reading the reference tree
and the reads (``io.fasta``, as ``models.pipeline`` calls it), in %."""

SPANS = {"parse": ["sparksmithwaterman_tpu_torch.models.pipeline:get_ref_seqs",
                   "sparksmithwaterman_tpu_torch.models.pipeline:get_reads"]}
ENTRIES = ()


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * trace.span_seconds("parse") / trace.window_s
