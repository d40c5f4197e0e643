"""Generator checkpoints in the reference state_dict layout."""
