"""One driver per kind of traffic, found by a traffic file's ``driver``
key."""
