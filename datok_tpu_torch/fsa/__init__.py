"""FSA layer: Foma parsing, automaton IR, runtime representations, serialization."""
