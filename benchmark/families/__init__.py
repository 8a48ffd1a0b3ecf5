"""Model families, one module per ``family`` of a configuration file: the
data generator, the reference's model, the system under test's bundle and
sampler (imported inside the call), and the operation counts."""
