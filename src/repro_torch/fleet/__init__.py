"""The parts of the JAX package's fleet plane that the event simulator's
default path reaches: the paper's heterogeneous cluster and the
contribution-balance metric.  Traces, capability tiers and participant
selection come with ROADMAP item A7."""
