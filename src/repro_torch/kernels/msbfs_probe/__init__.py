"""Word-packed multi-source bottom-up probe kernel."""
