"""The benchmark's machinery: the catalog of named files, the inputs, the
program's entries, the correctness check, the trace reduction and the
run itself."""
