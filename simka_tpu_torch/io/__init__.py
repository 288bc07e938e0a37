"""Host input: the input-file DSL, FASTA/FASTQ readers and 2-bit packing."""
