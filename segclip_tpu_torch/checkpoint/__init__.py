"""State-dict conversion into the port's reference key layout."""
