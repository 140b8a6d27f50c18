"""Graph500 parents from multi-source BFS depths (the Parents layer)."""
