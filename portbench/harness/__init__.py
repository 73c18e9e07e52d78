"""The benchmark's harness: what it runs of the program, how it times and
traces it, and how it judges what the program produced."""
