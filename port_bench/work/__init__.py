"""Work counts (operations and bytes) and the published peaks they are held against."""
