"""The reference's inverse transforms, one file each: a file names the
transform ids it inverts (IDS) and gives inverse(data)."""
