"""The harness: manifest, seeded weights and inputs, the cells' runners, the trace reader, the work counts and the judge."""
